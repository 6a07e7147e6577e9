"""Wavefront OBJ + MTL parsing into numpy arrays.

Replaces tinyobjloader + common/obj_loader.{h,cpp} from the reference with a
pure-numpy implementation.

Two consumption styles, mirroring the reference's two independent loaders:

  * load_mesh(path)      -> RawMesh: the voxelizer view (VoxelBuilder.hpp:51-70):
                            every vertex in file order plus flat triangle
                            vertex indices.  The mesh bbox is computed over
                            *all* vertices, so parsing must keep them all.
  * ObjLoader.load_model -> flattened per-corner render streams with trivial
                            0..N-1 indices, exactly like obj_loader.cpp:70-96:
                            texcoord V flipped (obj_loader.cpp:85), colors
                            defaulting to 0, material ids clamped to 0 when
                            out of range (obj_loader.cpp:100-104), flat
                            per-face normals computed when the file has none
                            (obj_loader.cpp:108-121), one default material
                            when the file has none (obj_loader.cpp:59-60).

Polygons with more than 3 corners are fan-triangulated (tinyobjloader's
default triangulation for convex faces).

Copied from voxelray_tpu/io/objload.py (numpy only, so the port
imports no JAX).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Material", "MaterialDedup", "RawMesh", "LoadedModel",
           "ObjLoader", "load_mesh", "load_materials", "write_obj"]


@dataclass
class Material:
    """MaterialObj equivalent (common/obj_loader.h:32-52) with its defaults."""

    ambient: tuple = (0.1, 0.1, 0.1)
    diffuse: tuple = (1.0, 1.0, 0.0)
    specular: tuple = (1.0, 1.0, 1.0)
    transmittance: tuple = (0.0, 0.0, 0.0)
    emission: tuple = (0.0, 0.0, 0.10)
    shininess: float = 0.0
    ior: float = 1.0
    dissolve: float = 1.0
    illum: int = 0
    texture_id: int = -1

    def as_row(self) -> np.ndarray:
        """Pack into the 20-float row layout used by device material arrays.

        Layout: ambient(3) diffuse(3) specular(3) transmittance(3)
        emission(3) shininess ior dissolve illum textureId — the field order
        of WaveFrontMaterial (src/shaders/host_device.h:103-115).
        """
        return np.array(
            [*self.ambient, *self.diffuse, *self.specular,
             *self.transmittance, *self.emission, self.shininess, self.ior,
             self.dissolve, float(self.illum), float(self.texture_id)],
            dtype=np.float32,
        )


class MaterialDedup:
    """`addMatrialIfNeeded` equivalent (src/voxelgrid.hpp:102-114).

    The reference keeps an unordered_map<MaterialObj, int16_t> on the
    grid so per-voxel materials can be deduplicated into a compact table;
    every in-repo caller passes the default material and the map is
    effectively disabled (setVoxel ignores it on the parallel path).
    This mirrors the exact semantics — value-equality dedup, int16
    indices, insertion order — so a materials-per-voxel workflow has the
    same tool available.
    """

    def __init__(self):
        self._index: dict[tuple, int] = {}
        self.materials: list[Material] = []

    def add_material_if_needed(self, material: Material) -> int:
        key = tuple(material.as_row().tolist())
        idx = self._index.get(key)
        if idx is None:
            idx = len(self.materials)
            if idx > 32767:  # int16_t, like the reference's map values
                raise OverflowError("more than 32767 distinct materials")
            self._index[key] = idx
            self.materials.append(material)
        return idx

    def rows(self) -> np.ndarray:
        if not self.materials:
            return np.zeros((0, 20), np.float32)
        return np.stack([m.as_row() for m in self.materials])


# Column indices into the packed material row (see Material.as_row).
MAT_AMBIENT = slice(0, 3)
MAT_DIFFUSE = slice(3, 6)
MAT_SPECULAR = slice(6, 9)
MAT_TRANSMITTANCE = slice(9, 12)
MAT_EMISSION = slice(12, 15)
MAT_SHININESS = 15
MAT_IOR = 16
MAT_DISSOLVE = 17
MAT_ILLUM = 18
MAT_TEXTURE_ID = 19


@dataclass
class RawMesh:
    """The voxelizer's view of an OBJ: all vertices + triangle indices."""

    vertices: np.ndarray           # (V, 3) float32, file order, all of them
    faces: np.ndarray              # (F, 3) int32 vertex indices
    face_material_ids: np.ndarray  # (F,) int32, -1 when unset
    materials: list = field(default_factory=list)   # list[Material]
    textures: list = field(default_factory=list)    # texture file names
    normals: np.ndarray | None = None     # (N, 3) float32 or None
    texcoords: np.ndarray | None = None   # (T, 2) float32 or None
    face_normal_ids: np.ndarray | None = None    # (F, 3) int32 or None
    face_texcoord_ids: np.ndarray | None = None  # (F, 3) int32 or None


@dataclass
class LoadedModel:
    """Flattened render streams (ObjLoader outputs, common/obj_loader.h:68-77)."""

    vertices: np.ndarray    # (N, 11) float32: pos(3) nrm(3) color(3) uv(2)
    indices: np.ndarray     # (N,) uint32 = arange(N)
    materials: np.ndarray   # (M, 20) float32 packed rows
    textures: list          # texture file names
    mat_index: np.ndarray   # (N/3,) int32 per-triangle material index

    @property
    def positions(self):
        return self.vertices[:, 0:3]

    @property
    def normals(self):
        return self.vertices[:, 3:6]

    @property
    def colors(self):
        return self.vertices[:, 6:9]

    @property
    def texcoords(self):
        return self.vertices[:, 9:11]


def _parse_index(token: str, count: int) -> int:
    """OBJ 1-based index -> 0-based; negative indices count from the end."""
    i = int(token)
    return i - 1 if i > 0 else count + i


def load_materials(path: str) -> tuple[list[Material], list[str]]:
    """Parse a .mtl file into Material rows + referenced texture names."""
    materials: list[Material] = []
    textures: list[str] = []
    cur: Material | None = None
    if not os.path.exists(path):
        return materials, textures
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = Material()
                materials.append(cur)
            elif cur is None:
                continue
            elif key == "Ka" and len(parts) >= 4:
                cur.ambient = tuple(float(x) for x in parts[1:4])
            elif key == "Kd" and len(parts) >= 4:
                cur.diffuse = tuple(float(x) for x in parts[1:4])
            elif key == "Ks" and len(parts) >= 4:
                cur.specular = tuple(float(x) for x in parts[1:4])
            elif key in ("Kt", "Tf") and len(parts) >= 4:
                cur.transmittance = tuple(float(x) for x in parts[1:4])
            elif key == "Ke" and len(parts) >= 4:
                cur.emission = tuple(float(x) for x in parts[1:4])
            elif key == "Ns":
                cur.shininess = float(parts[1])
            elif key == "Ni":
                cur.ior = float(parts[1])
            elif key == "d":
                cur.dissolve = float(parts[1])
            elif key == "Tr":
                cur.dissolve = 1.0 - float(parts[1])
            elif key == "illum":
                cur.illum = int(float(parts[1]))
            elif key == "map_Kd" and len(parts) >= 2:
                # store dir-resolved path so build_scene can load it
                name = os.path.join(os.path.dirname(os.path.abspath(path)),
                                    parts[-1])
                textures.append(name)
                cur.texture_id = len(textures) - 1
    return materials, textures


def load_mesh(path: str) -> RawMesh:
    """Parse an OBJ into the voxelizer's RawMesh view.

    Raises FileNotFoundError / ValueError like the reference throws on a bad
    path or an unparseable file (VoxelBuilder.hpp:54-65).
    """
    if not os.path.exists(path):
        raise FileNotFoundError(f"Path does not exist: {path}")

    verts: list[tuple] = []
    norms: list[tuple] = []
    uvs: list[tuple] = []
    tri_v: list[tuple] = []
    tri_n: list[tuple] = []
    tri_t: list[tuple] = []
    tri_mat: list[int] = []
    materials: list[Material] = []
    textures: list[str] = []
    mat_name_to_id: dict[str, int] = {}
    cur_mat = -1
    base_dir = os.path.dirname(os.path.abspath(path))

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v" and len(parts) >= 4:
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif key == "vn" and len(parts) >= 4:
                norms.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif key == "vt" and len(parts) >= 3:
                uvs.append((float(parts[1]), float(parts[2])))
            elif key == "f" and len(parts) >= 4:
                corners = []
                for tok in parts[1:]:
                    sub = tok.split("/")
                    vi = _parse_index(sub[0], len(verts))
                    ti = (_parse_index(sub[1], len(uvs))
                          if len(sub) > 1 and sub[1] else -1)
                    ni = (_parse_index(sub[2], len(norms))
                          if len(sub) > 2 and sub[2] else -1)
                    corners.append((vi, ti, ni))
                # fan triangulation for polygons
                for k in range(1, len(corners) - 1):
                    a, b, c = corners[0], corners[k], corners[k + 1]
                    tri_v.append((a[0], b[0], c[0]))
                    tri_t.append((a[1], b[1], c[1]))
                    tri_n.append((a[2], b[2], c[2]))
                    tri_mat.append(cur_mat)
            elif key == "usemtl" and len(parts) >= 2:
                cur_mat = mat_name_to_id.get(parts[1], -1)
            elif key == "mtllib" and len(parts) >= 2:
                mats, texs = load_materials(os.path.join(base_dir, parts[1]))
                # re-read the names so usemtl can map to ids
                offset = len(materials)
                names = _mtl_names(os.path.join(base_dir, parts[1]))
                for i, name in enumerate(names):
                    mat_name_to_id[name] = offset + i
                tex_offset = len(textures)
                for m in mats:
                    if m.texture_id >= 0:
                        m.texture_id += tex_offset
                materials.extend(mats)
                textures.extend(texs)

    v = np.asarray(verts, dtype=np.float32).reshape(-1, 3)
    f = np.asarray(tri_v, dtype=np.int32).reshape(-1, 3)
    return RawMesh(
        vertices=v,
        faces=f,
        face_material_ids=np.asarray(tri_mat, dtype=np.int32),
        materials=materials,
        textures=textures,
        normals=(np.asarray(norms, dtype=np.float32).reshape(-1, 3)
                 if norms else None),
        texcoords=(np.asarray(uvs, dtype=np.float32).reshape(-1, 2)
                   if uvs else None),
        face_normal_ids=(np.asarray(tri_n, dtype=np.int32).reshape(-1, 3)
                         if norms else None),
        face_texcoord_ids=(np.asarray(tri_t, dtype=np.int32).reshape(-1, 3)
                           if uvs else None),
    )


def _mtl_names(path: str) -> list[str]:
    names = []
    if not os.path.exists(path):
        return names
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if parts and parts[0] == "newmtl" and len(parts) > 1:
                names.append(parts[1])
    return names


class ObjLoader:
    """The render-path loader: flat per-corner streams, like obj_loader.cpp."""

    def load_model(self, path: str) -> LoadedModel:
        raw = load_mesh(path)
        materials = list(raw.materials)
        if not materials:
            materials = [Material()]  # default material (obj_loader.cpp:59-60)

        n_corners = raw.faces.size
        out = np.zeros((n_corners, 11), dtype=np.float32)
        vids = raw.faces.reshape(-1)
        out[:, 0:3] = raw.vertices[vids]

        if raw.normals is not None and raw.face_normal_ids is not None:
            nids = raw.face_normal_ids.reshape(-1)
            ok = nids >= 0
            out[ok, 3:6] = raw.normals[nids[ok]]
        if raw.texcoords is not None and raw.face_texcoord_ids is not None:
            tids = raw.face_texcoord_ids.reshape(-1)
            ok = tids >= 0
            uv = raw.texcoords[tids[ok]]
            out[ok, 9] = uv[:, 0]
            out[ok, 10] = np.float32(1.0) - uv[:, 1]  # V flip (obj_loader.cpp:85)

        # material index per triangle, clamped to 0 when out of range
        mat_idx = raw.face_material_ids.copy()
        mat_idx[(mat_idx < 0) | (mat_idx > len(materials))] = 0

        # flat per-face normals when the file provides none
        if raw.normals is None:
            p = out[:, 0:3].reshape(-1, 3, 3)
            n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
            norm = np.linalg.norm(n, axis=1, keepdims=True)
            n = np.where(norm > 0, n / np.maximum(norm, 1e-30), n)
            out[:, 3:6] = np.repeat(n, 3, axis=0)

        return LoadedModel(
            vertices=out,
            indices=np.arange(n_corners, dtype=np.uint32),
            materials=np.stack([m.as_row() for m in materials]),
            textures=list(raw.textures),
            mat_index=mat_idx.astype(np.int32),
        )


def write_obj(path: str, vertices, faces, mtl: str | None = None,
              usemtl: str | None = None) -> None:
    """Write a triangle mesh as OBJ (used to materialize test scenes)."""
    v = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    f = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    with open(path, "w") as fh:
        fh.write("# generated by voxelray_torch\n")
        if mtl:
            fh.write(f"mtllib {mtl}\n")
        for row in v:
            fh.write(f"v {row[0]:.9g} {row[1]:.9g} {row[2]:.9g}\n")
        if usemtl:
            fh.write(f"usemtl {usemtl}\n")
        for row in f:
            fh.write(f"f {row[0] + 1} {row[1] + 1} {row[2] + 1}\n")
