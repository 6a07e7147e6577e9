"""Procedural test meshes.

The reference repo's .gitignore accidentally excludes its Wavefront meshes
(SURVEY.md section 2.5), so the scenes it expects (cube, plane, bunny, a
1M-triangle scan) must be generated.  These produce numpy (vertices, faces)
pairs.  Copied from voxelray_tpu/io/meshes.py (numpy only) so the port
imports no JAX.
"""
from __future__ import annotations

import numpy as np

__all__ = ["cube", "plane", "icosphere", "bunny_like", "torus_knot",
           "deformed", "make_scene_mesh"]


def cube(size: float = 2.0, center=(0.0, 0.0, 0.0)):
    """Axis-aligned cube of edge `size`, 12 triangles, CCW outward."""
    h = size * 0.5
    cx, cy, cz = center
    corners = np.array(
        [[x, y, z] for z in (-h, h) for y in (-h, h) for x in (-h, h)],
        dtype=np.float32,
    ) + np.array([cx, cy, cz], dtype=np.float32)
    # corners indexed bit-wise: bit0=x+, bit1=y+, bit2=z+
    quads = [
        (0, 2, 3, 1),  # z-
        (4, 5, 7, 6),  # z+
        (0, 1, 5, 4),  # y-
        (2, 6, 7, 3),  # y+
        (0, 4, 6, 2),  # x-
        (1, 3, 7, 5),  # x+
    ]
    faces = []
    for a, b, c, d in quads:
        faces.append((a, b, c))
        faces.append((a, c, d))
    return corners, np.asarray(faces, dtype=np.int32)


def plane(size: float = 20.0, y: float = 0.0):
    """Ground quad in the XZ plane (the plane.obj stand-in, main.cpp:160)."""
    h = size * 0.5
    v = np.array(
        [[-h, y, -h], [h, y, -h], [h, y, h], [-h, y, h]], dtype=np.float32
    )
    f = np.array([[0, 2, 1], [0, 3, 2]], dtype=np.int32)
    return v, f


def icosphere(subdivisions: int = 3, radius: float = 1.0, center=(0, 0, 0)):
    """Subdivided icosahedron; 20*4^n triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdivisions):
        edge_mid: dict[tuple[int, int], int] = {}
        vlist = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            idx = edge_mid.get(key)
            if idx is None:
                m = vlist[a] + vlist[b]
                m /= np.linalg.norm(m)
                vlist.append(m)
                idx = len(vlist) - 1
                edge_mid[key] = idx
            return idx

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, dtype=np.int64)

    v = (verts * radius + np.asarray(center, dtype=np.float64)).astype(np.float32)
    return v, faces.astype(np.int32)


def bunny_like(subdivisions: int = 4):
    """Stanford-bunny stand-in: a lumpy, asymmetric blob with ear-like lobes.

    An icosphere displaced by a few fixed spherical harmonics-ish bumps so
    the occupancy pattern is non-trivial (concavities, thin features) while
    staying fully procedural and deterministic.
    """
    v, f = icosphere(subdivisions, radius=1.0)
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    r = (
        1.0
        + 0.18 * np.sin(3.0 * x) * np.cos(2.0 * y)
        + 0.12 * np.sin(5.0 * z + 1.0)
        + 0.35 * np.exp(-8.0 * ((x - 0.35) ** 2 + (z - 0.1) ** 2)) * (y > 0.3)
        + 0.35 * np.exp(-8.0 * ((x + 0.35) ** 2 + (z - 0.1) ** 2)) * (y > 0.3)
    )
    out = (v * r[:, None]).astype(np.float32)
    out[:, 1] += np.float32(1.0)  # sit above the ground plane
    return out, f


def torus_knot(p: int = 2, q: int = 3, segments: int = 512,
               tube_segments: int = 256, radius: float = 1.5,
               tube_radius: float = 0.35, center=(0.0, 1.2, 0.0)):
    """(p,q) torus knot tube; segments*tube_segments*2 triangles.

    torus_knot(2, 3, 1024, 512) is ~1.05M triangles — the "1M-triangle scan
    mesh" stand-in for BASELINE config 4.
    """
    t = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    r = radius * (2.0 + np.cos(q * t)) * 0.5
    cx = r * np.cos(p * t)
    cy = radius * 0.5 * np.sin(q * t)
    cz = r * np.sin(p * t)
    cpts = np.stack([cx, cy, cz], axis=-1)

    # Frenet-ish frame via finite differences
    tang = np.roll(cpts, -1, axis=0) - np.roll(cpts, 1, axis=0)
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    ref = np.array([0.0, 1.0, 0.0])
    n1 = np.cross(tang, ref)
    bad = np.linalg.norm(n1, axis=1) < 1e-6
    n1[bad] = np.cross(tang[bad], np.array([1.0, 0.0, 0.0]))
    n1 /= np.linalg.norm(n1, axis=1, keepdims=True)
    n2 = np.cross(tang, n1)

    phi = np.linspace(0.0, 2.0 * np.pi, tube_segments, endpoint=False)
    ring = (np.cos(phi)[:, None, None] * n1[None] +
            np.sin(phi)[:, None, None] * n2[None])  # (T, S, 3)
    pts = cpts[None] + tube_radius * ring            # (T, S, 3)
    verts = pts.transpose(1, 0, 2).reshape(-1, 3)    # segment-major
    verts = (verts + np.asarray(center)).astype(np.float32)

    s_idx = np.arange(segments)
    t_idx = np.arange(tube_segments)
    s0 = s_idx[:, None]
    s1 = (s_idx[:, None] + 1) % segments
    t0 = t_idx[None, :]
    t1 = (t_idx[None, :] + 1) % tube_segments

    def vid(s, t):
        return s * tube_segments + t

    a, b, c, d = vid(s0, t0), vid(s1, t0), vid(s1, t1), vid(s0, t1)
    f1 = np.stack([a, b, c], axis=-1).reshape(-1, 3)
    f2 = np.stack([a, c, d], axis=-1).reshape(-1, 3)
    return verts, np.concatenate([f1, f2]).astype(np.int32)


def deformed(vertices, phase: float, amplitude: float = 0.15):
    """Time-varying sinusoidal deformation for the re-voxelization config."""
    v = np.asarray(vertices, dtype=np.float32)
    out = v.copy()
    out[:, 0] += amplitude * np.sin(2.5 * v[:, 1] + phase).astype(np.float32)
    out[:, 1] += amplitude * np.cos(1.7 * v[:, 2]
                                    + 0.8 * phase).astype(np.float32)
    out[:, 2] += amplitude * np.sin(2.1 * v[:, 0]
                                    - 0.6 * phase).astype(np.float32)
    return out


_REGISTRY = {
    "cube": lambda: cube(),
    "plane": lambda: plane(),
    "bunny": lambda: bunny_like(4),
    "sphere": lambda: icosphere(4),
    "knot": lambda: torus_knot(),
    "knot1m": lambda: torus_knot(2, 3, 1024, 512),
}


def make_scene_mesh(name: str):
    """Look up a named test mesh -> (vertices, faces)."""
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(f"unknown mesh '{name}'; have {sorted(_REGISTRY)}")
