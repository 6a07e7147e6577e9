"""Scene assembly: triangle models + voxel geometry + lights, on one device.

Counterpart of voxelray_tpu/models/scene.py.  The reference's engine keeps
per-model device buffers, a TLAS with one instance per OBJ model and one
procedural AABB instance (hello_vulkan.cpp:737-793), and push-constant
light state (hello_vulkan.h:84-91).  Here the scene is a flat set of
tensors:

  * all mesh triangles concatenated (instance transforms pre-applied),
    with per-triangle material ids resolved into one global material
    table, per-triangle texture layers, a mip-atlas texture stack with
    its per-level placements, and the triangle accel (the "triangle
    BLAS", ops/tri_accel.py) once a mesh passes 256 triangles;
  * voxel geometry as the dense occupancy grid and its BrickAccel (the
    "procedural BLAS", hello_vulkan.cpp:699-715), the flat AABB list the
    brute backend traces, and optionally a Morton octree;
  * light defaults matching the app's startup values (lightPosition
    (10,55,8), intensity 1000, point light, hello_vulkan.h:84-91).

`plan_scene` / `build_scene_planned` are the triangle scene of meshes whose
topology stays fixed and whose vertices move every step (an animated,
skinned or simulated mesh): what does not depend on the positions goes to
the device once, and each step makes the corners, the flat normals,
tri_lod and the triangle accel from the step's vertices on the device.

Mesh materials are converted sRGB -> linear on load (pow 2.2,
hello_vulkan.cpp:204-208); the voxel default material is uploaded raw.
Every array is built with the JAX package's numpy expressions, so the
tensors are bit-equal to its Scene's.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..io.objload import Material
from ..io.textures import build_mip_chain, load_texture
from ..ops.aabbs import extract_aabbs
from ..ops.kernels import tri_bin
from ..ops.traverse_fast import build_accel
from ..ops.tri_accel import build_tri_accel_planned, plan_tri_accel
from ..utils import trace
from ..utils.device import resolve_device

__all__ = ["Scene", "Light", "build_scene", "ScenePlan", "plan_scene",
           "build_scene_planned"]


@dataclass(frozen=True)
class Light:
    """PushConstantRay light state (host_device.h:87-93)."""

    position: tuple = (10.0, 55.0, 8.0)
    intensity: float = 1000.0
    type: int = 0  # 0 = point, 1 = directional


def _srgb_to_linear_rows(mat_rows: np.ndarray) -> np.ndarray:
    """ambient/diffuse/specular **= 2.2 (hello_vulkan.cpp:204-208)."""
    out = mat_rows.copy()
    out[:, 0:9] = np.power(out[:, 0:9], np.float32(2.2))
    return out


@dataclass(frozen=True)
class Scene:
    """Device-resident scene.  Triangle streams are globally concatenated."""

    tri_v0: Any                     # float32[F, 3] world-space corners
    tri_v1: Any
    tri_v2: Any
    tri_n0: Any                     # per-corner normals
    tri_n1: Any
    tri_n2: Any
    tri_uv0: Any                    # float32[F, 2]
    tri_uv1: Any
    tri_uv2: Any
    tri_mat: Any                    # int32[F] -> rows of materials
    tri_tex: Any                    # int32[F] -> texture layer or -1
    tri_lod: Any                    # float32[F] texel-density log2 term
    materials: Any                  # float32[M, 20] packed rows
    textures: Any                   # float32[T, TH, TWA, 3] mip atlases
    tex_meta: Any                   # int32[T, LMAX, 4] (y0, x0, h, w)
    voxel_aabbs: Any                # float32[N, 6] voxel boxes
    voxel_material: Any             # float32[20] (default MaterialObj)
    occ_flat: Any                   # uint8[X*Y*Z] dense occupancy
    grid_origin: Any                # float32[3]
    accel: Any                      # BrickAccel or None
    octree: Any                     # models.octree.Octree or None
    tri_accel: Any                  # ops.tri_accel.TriAccel or None
    grid_dims: tuple
    grid_voxel_size: float

    @property
    def device(self):
        return self.occ_flat.device

    @property
    def n_triangles(self):
        return int(self.tri_v0.shape[0])

    @property
    def n_voxels(self):
        return int(self.voxel_aabbs.shape[0])


def _triangle_streams(models, transforms):
    """The models' per-triangle arrays, materials and texture files, with
    the JAX package's numpy expressions (scene.py:118-180)."""
    v0s, v1s, v2s, n0s, n1s, n2s = [], [], [], [], [], []
    uv0s, uv1s, uv2s = [], [], []
    mats_rows, mat_ids, tex_ids = [], [], []
    textures: list[np.ndarray] = []
    mat_offset = 0
    for model, xf in zip(models, transforms):
        verts = np.asarray(model.vertices, np.float32)
        pos = verts[:, 0:3]
        nrm = verts[:, 3:6]
        uv = verts[:, 9:11]
        if xf is not None:
            m = np.asarray(xf, np.float32)
            pos = pos @ m[:3, :3].T + m[:3, 3]
            n_mat = np.linalg.inv(m[:3, :3]).T
            nrm = nrm @ n_mat.T
        idx = np.asarray(model.indices).reshape(-1, 3)
        v0s.append(pos[idx[:, 0]])
        v1s.append(pos[idx[:, 1]])
        v2s.append(pos[idx[:, 2]])
        n0s.append(nrm[idx[:, 0]])
        n1s.append(nrm[idx[:, 1]])
        n2s.append(nrm[idx[:, 2]])
        uv0s.append(uv[idx[:, 0]])
        uv1s.append(uv[idx[:, 1]])
        uv2s.append(uv[idx[:, 2]])
        rows = _srgb_to_linear_rows(np.asarray(model.materials, np.float32))
        mats_rows.append(rows)
        mat_ids.append(np.asarray(model.mat_index, np.int32) + mat_offset)
        # texture id per triangle resolved through its material; the
        # model's texture files load now (magenta on failure,
        # hello_vulkan.cpp:323-331)
        tex_of_mat = rows[:, 19].astype(np.int32)
        tex_base = len(textures)
        for name in model.textures:
            textures.append(load_texture(name))
        per_tri_tex = tex_of_mat[np.asarray(model.mat_index, np.int32)]
        tex_ids.append(np.where(per_tri_tex >= 0, per_tri_tex + tex_base, -1))
        mat_offset += len(rows)
    if models:
        cat = np.concatenate
        streams = dict(
            tri_v0=cat(v0s), tri_v1=cat(v1s), tri_v2=cat(v2s),
            tri_n0=cat(n0s), tri_n1=cat(n1s), tri_n2=cat(n2s),
            tri_uv0=cat(uv0s), tri_uv1=cat(uv1s), tri_uv2=cat(uv2s),
            tri_mat=cat(mat_ids), tri_tex=cat(tex_ids))
        materials = cat(mats_rows)
    else:
        z3, z2 = np.zeros((0, 3), np.float32), np.zeros((0, 2), np.float32)
        streams = dict(tri_v0=z3, tri_v1=z3, tri_v2=z3, tri_n0=z3,
                       tri_n1=z3, tri_n2=z3, tri_uv0=z2, tri_uv1=z2,
                       tri_uv2=z2, tri_mat=np.zeros((0,), np.int32),
                       tri_tex=np.zeros((0,), np.int32))
        materials = Material().as_row()[None]
    return streams, materials, textures


def _texture_atlas(textures):
    """Mip atlases: level 0 top-left, levels >= 1 stacked down the column
    to its right; tex_meta[t, level] = (y0, x0, h, w), levels past a
    texture's chain clamped to its last (scene.py:182-212).  A 1x1 white
    dummy when there is no texture (hello_vulkan.cpp:297-312)."""
    if not textures:
        textures = [np.ones((1, 1, 3), np.float32)]
    chains = [build_mip_chain(t) for t in textures]
    lmax = max(len(c) for c in chains)
    th = max(max(c[0].shape[0], sum(lv.shape[0] for lv in c[1:]))
             for c in chains)
    tw = max(c[0].shape[1] + (c[1].shape[1] if len(c) > 1 else 0)
             for c in chains)
    tex_stack = np.zeros((len(chains), th, tw, 3), np.float32)
    tex_meta = np.zeros((len(chains), lmax, 4), np.int32)
    for i, chain in enumerate(chains):
        h0, w0 = chain[0].shape[:2]
        tex_stack[i, :h0, :w0] = chain[0]
        tex_meta[i, 0] = (0, 0, h0, w0)
        ycur = 0
        for lv, img in enumerate(chain[1:], start=1):
            hl, wl = img.shape[:2]
            tex_stack[i, ycur: ycur + hl, w0: w0 + wl] = img
            tex_meta[i, lv] = (ycur, w0, hl, wl)
            ycur += hl
        for lv in range(len(chain), lmax):
            tex_meta[i, lv] = tex_meta[i, len(chain) - 1]
    return tex_stack, tex_meta, len(chains)


def _tri_lod(streams, tex_meta, n_layers):
    """0.5 * log2(texels covered / world area) per triangle, the footprint
    mip-selection constant (scene.py:214-235)."""
    v0, v1, v2 = streams["tri_v0"], streams["tri_v1"], streams["tri_v2"]
    if not len(v0):
        return np.zeros((0,), np.float32)
    uv_e1 = streams["tri_uv1"] - streams["tri_uv0"]
    uv_e2 = streams["tri_uv2"] - streams["tri_uv0"]
    uv_area = 0.5 * np.abs(uv_e1[:, 0] * uv_e2[:, 1]
                           - uv_e1[:, 1] * uv_e2[:, 0])
    w_area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    tri_tex = streams["tri_tex"]
    layer = np.clip(tri_tex, 0, n_layers - 1)
    texels = (tex_meta[layer, 0, 2].astype(np.float64)
              * tex_meta[layer, 0, 3])
    dens = uv_area * texels / np.maximum(w_area, 1e-20)
    return np.where(tri_tex >= 0, 0.5 * np.log2(np.maximum(dens, 1e-20)),
                    0.0).astype(np.float32)


def _tri_res(n_tri):
    """The tri grid's cells on its longest axis: scaled with the triangle
    count (~4 tris per nonempty cell on surface meshes), 16 to 256."""
    return int(np.clip(round(float(n_tri) ** (1 / 2.2)), 16, 256))


def _wants_accel(n_tri, tri_accel):
    return bool(n_tri) and (tri_accel is True
                            or (tri_accel == "auto" and n_tri >= 256))


def _build_tri_accel(v0, v1, v2, device):
    """The triangle BLAS of three (F, 3) corner streams: the planned build
    over the triangles' own box (rows never cut; None, the brute trace,
    where a cell outgrows the widest row)."""
    corners = np.stack([v0, v1, v2], axis=1).reshape(-1, 3)
    plan = plan_tri_accel(np.arange(len(corners)).reshape(-1, 3),
                          len(corners), bb_min=corners.min(axis=0),
                          bb_max=corners.max(axis=0), res=_tri_res(len(v0)),
                          device=device)
    return build_tri_accel_planned(plan, corners)


def _triangle_side(streams, materials, textures, device):
    """A scene's triangle fields on `device`: the streams, tri_lod, the
    materials, the texture atlas and tex_meta."""
    tex_stack, tex_meta, n_layers = _texture_atlas(textures)

    def as_t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return dict(**{k: as_t(v) for k, v in streams.items()},
                tri_lod=as_t(_tri_lod(streams, tex_meta, n_layers)),
                materials=as_t(materials), textures=as_t(tex_stack),
                tex_meta=as_t(tex_meta))


@functools.lru_cache(maxsize=8)
def _no_models_on(device):
    """The triangle fields of a scene without models on `device` (empty
    streams, the default material row, the 1x1 dummy atlas), made once for
    each device: a host-to-device copy syncs, and a voxel scene rebuilt
    every step would copy them anew.  Shared, read-only, by the scenes
    built there."""
    return _triangle_side(*_triangle_streams([], []), device)


@functools.lru_cache(maxsize=32)
def _small_on(data, dtype, shape, device):
    return torch.as_tensor(np.frombuffer(data, dtype).reshape(shape).copy(),
                           device=device)


def _const_on(x, device):
    """The small host array x (the voxel material row, the grid origin) as
    a tensor on `device`, made once for each value and device, as
    _no_models_on's fields are; shared, read-only."""
    x = np.ascontiguousarray(x)
    return _small_on(x.tobytes(), x.dtype.str, x.shape, device)


@trace.spanned("build_scene")
def build_scene(models=None, grid=None, aabbs=None,
                voxel_material: Material | None = None, transforms=None,
                octree=None, tri_accel="auto", device=None) -> Scene:
    """Assemble a Scene on `device` (default: the CUDA card).

    models: list of LoadedModel (io/objload.py render streams).
    grid: a grid encoding (GridBool, GridAabbStruct, GridVec, Octree) or
        a voxelize_mesh result dict: the voxel geometry.  An Octree given
        as grid also serves as the scene's octree.
    aabbs: the voxel boxes the brute backend traces, (N, 6); by default
        the grid's occupied cells in linear order, extracted on the
        device.
    octree: the octree the "octree" backend walks.
    transforms: optional per-model 4x4 matrices, pre-applied to vertices
        and inverse-transposed to normals.
    tri_accel: "auto" builds the triangle accel once the meshes pass 256
        triangles (below that the brute trace is cheaper), True forces
        it, False/None keeps the brute trace.
    """
    from .octree import Octree
    if octree is None and isinstance(grid, Octree):
        octree = grid
    dev = resolve_device(device)
    models = models or []
    if models:
        transforms = transforms or [None] * len(models)
        streams, materials, textures = _triangle_streams(models, transforms)
        tri = _triangle_side(streams, materials, textures, dev)
    else:
        tri = _no_models_on(dev)

    if grid is None:
        occ = torch.zeros((0, 0, 0), dtype=torch.uint8, device=dev)
        g_dims, g_org, g_vs = (0, 0, 0), np.zeros(3, np.float32), 1.0
    elif isinstance(grid, dict):
        occ = grid["occ"]
        g_dims, g_org, g_vs = grid["dims"], grid["origin"], grid["voxel_size"]
    else:
        occ = grid.occupancy()
        g_dims, g_org, g_vs = grid.dims, grid.origin, grid.voxel_size
    occ = torch.as_tensor(occ).to(device=dev, dtype=torch.uint8)
    g_org = np.asarray(g_org, np.float32)
    accel = build_accel(occ, g_org, float(g_vs)) if occ.numel() else None
    vmat = _const_on((voxel_material or Material()).as_row(), dev)
    origin = _const_on(g_org, dev)
    if aabbs is None:
        # on the card the nonzero in here is the build's one host sync,
        # made once the accel's kernels are queued: the card works while
        # the host waits
        aabbs = extract_aabbs({"occ": occ, "dims": g_dims, "origin": g_org,
                               "voxel_size": g_vs})
    aabbs = torch.as_tensor(aabbs).to(device=dev, dtype=torch.float32)

    ta = None
    if models and _wants_accel(len(streams["tri_v0"]), tri_accel):
        ta = _build_tri_accel(streams["tri_v0"], streams["tri_v1"],
                              streams["tri_v2"], dev)
    return Scene(
        **tri, voxel_aabbs=aabbs.reshape(-1, 6), voxel_material=vmat,
        occ_flat=occ.reshape(-1), grid_origin=origin,
        accel=accel, octree=octree, tri_accel=ta,
        grid_dims=tuple(int(x) for x in g_dims),
        grid_voxel_size=float(g_vs))


class ScenePlan:
    """The triangle scene of `models` whose topology stays fixed, set up
    once for a scene a step (build_scene_planned).

    A step's vertices are the models' vertices concatenated in order, (V,
    3) world-space positions; each model's indices pick its corners from
    its own rows.  Set up once, on `device` (default: the CUDA card): the
    faces over those V rows, the UVs, material and texture ids, the
    materials, textures and mip atlas (build_scene's), the voxel side
    empty, and the triangle accel's plan (build_scene's "auto" tri_accel
    rule and its res) over bb_min..bb_max, the caller's promise of a box
    that holds every step's vertices (default: the models' own bounding
    box); tri_lod too where no triangle is textured.  The models'
    positions and normals are read only for that default box.
    """

    def __init__(self, models, *, bb_min=None, bb_max=None,
                 voxel_material: Material | None = None, device=None):
        dev = self.device = resolve_device(device)
        streams, materials, textures = _triangle_streams(
            models, [None] * len(models))
        tex_stack, tex_meta, n_layers = _texture_atlas(textures)
        faces, base = [], 0
        for model in models:
            faces.append(np.asarray(model.indices, np.int64).reshape(-1, 3)
                         + base)
            base += len(model.vertices)
        faces = (np.concatenate(faces) if faces
                 else np.zeros((0, 3), np.int64))
        self.n_vertices, self.n_triangles = base, len(faces)

        def as_t(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=dev)

        self.faces = as_t(faces)
        self.corners = self.faces.reshape(-1)
        occ = torch.zeros((0, 0, 0), dtype=torch.uint8, device=dev)
        g_org = np.zeros(3, np.float32)
        aabbs = extract_aabbs({"occ": occ, "dims": (0, 0, 0),
                               "origin": g_org, "voxel_size": 1.0})
        self.fixed = dict(
            **{k: as_t(streams[k]) for k in ("tri_uv0", "tri_uv1",
                                             "tri_uv2", "tri_mat",
                                             "tri_tex")},
            materials=as_t(materials), textures=as_t(tex_stack),
            tex_meta=as_t(tex_meta),
            voxel_aabbs=torch.as_tensor(aabbs).to(
                device=dev, dtype=torch.float32).reshape(-1, 6),
            voxel_material=as_t((voxel_material or Material()).as_row()),
            occ_flat=occ.reshape(-1), grid_origin=as_t(g_org), accel=None,
            octree=None, grid_dims=(0, 0, 0), grid_voxel_size=1.0)
        # tri_lod: fixed where nothing is textured, else its position-free
        # factor, uv area x texels (float64, as _tri_lod)
        tri_tex = streams["tri_tex"]
        self.tri_lod = self.lod_factor = None
        if (tri_tex >= 0).any():
            uv_e1 = streams["tri_uv1"] - streams["tri_uv0"]
            uv_e2 = streams["tri_uv2"] - streams["tri_uv0"]
            uv_area = 0.5 * np.abs(uv_e1[:, 0] * uv_e2[:, 1]
                                   - uv_e1[:, 1] * uv_e2[:, 0])
            layer = np.clip(tri_tex, 0, n_layers - 1)
            texels = (tex_meta[layer, 0, 2].astype(np.float64)
                      * tex_meta[layer, 0, 3])
            self.lod_factor = as_t(uv_area * texels)
            self.textured = as_t(tri_tex >= 0)
        else:
            self.tri_lod = as_t(_tri_lod(streams, tex_meta, n_layers))
        self.tri = None
        if _wants_accel(self.n_triangles, "auto"):
            if bb_min is None or bb_max is None:
                corners = np.concatenate([streams["tri_v0"],
                                          streams["tri_v1"],
                                          streams["tri_v2"]])
                bb_min, bb_max = corners.min(axis=0), corners.max(axis=0)
            self.tri = plan_tri_accel(faces, self.n_vertices, bb_min=bb_min,
                                      bb_max=bb_max,
                                      res=_tri_res(self.n_triangles),
                                      device=dev)


def plan_scene(models, **kw) -> ScenePlan:
    return ScenePlan(models, **kw)


@trace.spanned("build_scene_planned")
def build_scene_planned(plan: ScenePlan, vertices, normals=None) -> Scene:
    """The plan's scene over one step's vertices, (V, 3) float32 (numpy is
    copied to the plan's device first).

    normals: (V, 3) vertex normals, each corner taking its vertex's; by
    default each triangle's flat face normal, as the loader gives a mesh
    without normals.  The corners, the normals, tri_lod and the triangle
    accel (build_tri_accel_planned: None, the brute trace, where a cell
    outgrows the widest row) are made on the device (the corners, the
    flat normals and the areas by one tri_bin.corners call, a kernel on
    the card); on CPU tensors the
    Scene equals build_scene(models=...) of the same positions, array for
    array and table for table.
    """
    dev = plan.device
    v = torch.as_tensor(vertices, dtype=torch.float32,
                        device=dev).reshape(-1, 3)
    if v.shape[0] != plan.n_vertices:
        raise ValueError(f"{v.shape[0]} vertices; the plan has "
                         f"{plan.n_vertices}")
    corners = tri_bin.corners if dev.type == "cuda" else tri_bin.corners_plain
    tri9, v0, v1, v2, flat, area = corners(v.contiguous(), plan.corners)
    if normals is None:
        n0 = n1 = n2 = flat
    else:
        nrm = torch.as_tensor(normals, dtype=torch.float32,
                              device=dev).reshape(-1, 3)
        n0, n1, n2 = (nrm[plan.faces[:, k]] for k in range(3))
    tri_lod = plan.tri_lod
    if tri_lod is None:
        dens = plan.lod_factor / torch.clamp(area, min=1e-20).double()
        tri_lod = torch.where(
            plan.textured, 0.5 * torch.log2(torch.clamp(dens, min=1e-20)),
            0.0).float()
    ta = None
    if plan.tri is not None:
        ta = build_tri_accel_planned(plan.tri, v, tri9=tri9)
    return Scene(tri_v0=v0, tri_v1=v1, tri_v2=v2, tri_n0=n0, tri_n1=n1,
                 tri_n2=n2, tri_lod=tri_lod, tri_accel=ta, **plan.fixed)
