"""The benchmark's inputs: the mesh, the triangle model's streams and the
camera fly-through.

Everything a cell feeds the program is made here, from the configuration,
the traffic mix and the seed, and handed unchanged to both the program and
the reference.  Each generator is a copy, so a later change to the
program cannot move the inputs:

  torus_knot    voxelray_torch/io/meshes.py:127-163 (numpy, host)
  deformed      voxelray_torch/io/meshes.py:167-177 (numpy, host)
  knot_streams  chip_smoke.py:558-574 (knot_model's flat-normal streams)
  look_at, perspective_rh_zo, camera_matrices
                voxelray_torch/render/camera.py:30-97
  orbit_eyes    voxelray_torch/render/camera.py:100-111 (orbit_path), at
                the bench camera's radius and height
                (voxelray_torch/bench.py:279-293)

The mesh, and a changing scene's vertex sets, are a fixed function of the
configuration (no seed); the seed picks where on the orbit the window
starts and which frames are checked.  Window frame i is the global step
start + i: it looks from camera step % cameras and, in a scene whose
geometry changes, takes vertex set step % sets.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["torus_knot", "deformed", "mesh_of", "bbox", "grid_of",
           "Geometry", "knot_streams", "look_at", "perspective_rh_zo",
           "camera_matrices", "orbit_eyes", "Flight"]


def torus_knot(p=2, q=3, segments=512, tube_segments=256, radius=1.5,
               tube_radius=0.35, center=(0.0, 1.2, 0.0)):
    """(p, q) torus knot tube: (vertices (V, 3) float32, faces (F, 3)
    int32), segments * tube_segments * 2 triangles."""
    t = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    r = radius * (2.0 + np.cos(q * t)) * 0.5
    cpts = np.stack([r * np.cos(p * t), radius * 0.5 * np.sin(q * t),
                     r * np.sin(p * t)], axis=-1)
    tang = np.roll(cpts, -1, axis=0) - np.roll(cpts, 1, axis=0)
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    n1 = np.cross(tang, np.array([0.0, 1.0, 0.0]))
    bad = np.linalg.norm(n1, axis=1) < 1e-6
    n1[bad] = np.cross(tang[bad], np.array([1.0, 0.0, 0.0]))
    n1 /= np.linalg.norm(n1, axis=1, keepdims=True)
    n2 = np.cross(tang, n1)
    phi = np.linspace(0.0, 2.0 * np.pi, tube_segments, endpoint=False)
    ring = (np.cos(phi)[:, None, None] * n1[None]
            + np.sin(phi)[:, None, None] * n2[None])
    pts = cpts[None] + tube_radius * ring
    verts = pts.transpose(1, 0, 2).reshape(-1, 3)
    verts = (verts + np.asarray(center)).astype(np.float32)
    s0 = np.arange(segments)[:, None]
    s1 = (s0 + 1) % segments
    t0 = np.arange(tube_segments)[None, :]
    t1 = (t0 + 1) % tube_segments
    a, b = s0 * tube_segments + t0, s1 * tube_segments + t0
    c, d = s1 * tube_segments + t1, s0 * tube_segments + t1
    f1 = np.stack([a, b, c], axis=-1).reshape(-1, 3)
    f2 = np.stack([a, c, d], axis=-1).reshape(-1, 3)
    return verts, np.concatenate([f1, f2]).astype(np.int32)


def deformed(vertices, phase, amplitude=0.15):
    """The vertices under a time-varying sinusoidal deformation (float32)."""
    v = np.asarray(vertices, dtype=np.float32)
    out = v.copy()
    out[:, 0] += amplitude * np.sin(2.5 * v[:, 1] + phase).astype(np.float32)
    out[:, 1] += amplitude * np.cos(1.7 * v[:, 2]
                                    + 0.8 * phase).astype(np.float32)
    out[:, 2] += amplitude * np.sin(2.1 * v[:, 0]
                                    - 0.6 * phase).astype(np.float32)
    return out


def mesh_of(config):
    """The configuration's mesh, (vertices, faces)."""
    mesh = config["mesh"]
    if mesh["kind"] != "torus_knot":
        raise ValueError(f"unknown mesh kind {mesh['kind']!r}")
    return torus_knot(**{k: v for k, v in mesh.items() if k != "kind"})


def bbox(v):
    """(min, max) corners over every vertex, float32
    (VoxelBuilder.hpp:198-224)."""
    return v.min(axis=0).astype(np.float32), v.max(axis=0).astype(np.float32)


def grid_of(v, grid_res):
    """(bb_min, bb_max, voxel size, dims) of the grid with `grid_res` cells
    on the mesh's longest axis, in the reference app's float32 math
    (VoxelBuilder.hpp:347-349)."""
    bb_min, bb_max = bbox(v)
    vs = float(max(bb_max - bb_min)) / grid_res
    ext = (bb_max - bb_min) / np.float32(vs)
    dims = tuple(int(x) for x in np.ceil(ext).astype(np.int64))
    return bb_min, bb_max, vs, dims


@dataclass
class Geometry:
    """What a configuration's scene is made of, handed unchanged to the
    program and the reference: the faces, the vertex sets (one for a
    scene that never changes) and, for a voxel scene, the grid (grid_of's
    tuple)."""

    faces: np.ndarray
    sets: list
    grid: tuple = None

    def key(self, step):
        """Which vertex set global step `step` takes."""
        return step % len(self.sets)

    @property
    def bbox(self):
        """(min, max) over every vertex of every set."""
        boxes = [bbox(v) for v in self.sets]
        return (np.min([b[0] for b in boxes], axis=0),
                np.max([b[1] for b in boxes], axis=0))


def knot_streams(v, f):
    """The mesh as an OBJ without normals or UVs flattens: per-corner
    positions (3F, 11) float32 rows (pos, flat face normal, colour, uv)."""
    pos = v[f].reshape(-1, 3)
    p = pos.reshape(-1, 3, 3)
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(norm > 0, n / np.maximum(norm, 1e-30), n)
    verts = np.zeros((len(pos), 11), np.float32)
    verts[:, 0:3] = pos
    verts[:, 3:6] = np.repeat(n, 3, axis=0)
    return verts


def look_at(eye, center, up):
    """glm::lookAtRH, row-major float32 (apply as M @ v)."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    s = np.cross(fwd, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, fwd)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -fwd
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(fwd, eye)
    return m


def perspective_rh_zo(fov_y_rad, aspect, z_near, z_far):
    """glm::perspectiveRH_ZO with the Vulkan Y flip."""
    t = np.float32(np.tan(fov_y_rad * 0.5))
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = -1.0 / t
    m[2, 2] = z_far / (z_near - z_far)
    m[2, 3] = -(z_far * z_near) / (z_far - z_near)
    m[3, 2] = -1.0
    return m


def camera_matrices(eye, center, width, height, fov_deg=60.0, z_near=0.1,
                    z_far=1000.0, up=(0.0, 1.0, 0.0)):
    """(view_inverse, proj_inverse) float32, as the renderer takes them."""
    aspect = np.float32(width) / np.float32(height)
    view = look_at(eye, center, up)
    proj = perspective_rh_zo(np.radians(np.float32(fov_deg)), aspect,
                             np.float32(z_near), np.float32(z_far))
    return (np.linalg.inv(view).astype(np.float32),
            np.linalg.inv(proj).astype(np.float32))


def orbit_eyes(n, center, radius, height):
    """n eyes evenly around the orbit, angle 2 pi i / n."""
    eyes = []
    for i in range(n):
        a = 2.0 * np.pi * i / max(1, n)
        eyes.append((center[0] + radius * np.cos(a), height,
                     center[2] + radius * np.sin(a)))
    return eyes


class Flight:
    """The fly-through: the orbit's cameras, the window's start on it and
    the frames to check, all from the traffic mix and the seed.

    Frame i of the window looks from camera (start + i) % n.  Every seed
    flies the same n cameras, from another start, so seeds change the
    order of the work and not the work.
    """

    def __init__(self, traffic, bb_min, bb_max, width, height, seed,
                 candidates=None):
        center = (np.asarray(bb_min, np.float64)
                  + np.asarray(bb_max, np.float64)) * 0.5
        extent = float(max(np.asarray(bb_max) - np.asarray(bb_min)))
        offset = np.asarray(traffic["eye_offset"], np.float64)
        radius = float(np.linalg.norm(offset * extent))
        height_y = float(center[1] + traffic["height_factor"] * extent)
        self.n = int(traffic["cameras"])
        self.center = tuple(float(c) for c in center)
        eyes = orbit_eyes(self.n, self.center, radius, height_y)
        self.mats = [camera_matrices(e, self.center, width, height)
                     for e in eyes]
        rng = np.random.default_rng(int(seed))
        self.start = int(rng.integers(self.n))
        # the frames checked after the window: among `candidates`, by
        # default the first revolution, which every window completes
        pool = list(range(self.n) if candidates is None else candidates)
        k = min(int(traffic["check_frames"]), len(pool))
        self.check = sorted(int(i) for i in
                            rng.choice(pool, size=k, replace=False))

    def step(self, i):
        """The global step of the window's frame i."""
        return self.start + i

    def camera(self, i):
        """Index on the orbit of the window's frame i."""
        return self.step(i) % self.n

    def matrices(self, i):
        return self.mats[self.camera(i)]
