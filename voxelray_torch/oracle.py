"""Trusted NumPy oracle voxelizer.

Copied from voxelray_tpu/oracle.py (numpy only, with the port's own
grid_dims / mesh_bbox), so the CUDA voxelizer is gated without JAX.  A
direct semantic transcription of the reference CPU voxelizer
(src/VoxelBuilder.hpp:118-196 serial path, identical occupancy on the
parallel path), kept deliberately simple so it can gate the fast
implementations bit-for-bit:

  * per-triangle clamped voxel window with the `+2` slack
    (VoxelBuilder.hpp:175-184),
  * Akenine-Möller separating-axis triangle/box test: 3 box axes, 9
    edge-cross axes with the 1e-8 degenerate-axis skip, triangle-plane test
    with the 1e-8 degenerate-normal skip (VoxelBuilder.hpp:73-162),
  * all arithmetic float32 with the same expression shapes.

Each triangle's window is tested as one vectorized numpy batch (the oracle
is "slow but trusted", not "slow and useless" — ~10^5 tris/s).
"""
from __future__ import annotations

import numpy as np

from .ops.geometry import grid_dims, mesh_bbox

__all__ = ["oracle_voxelize", "oracle_tri_box_overlap", "OracleResult"]

_EPS = np.float32(1e-8)


def oracle_tri_box_overlap(centers, half, v0, v1, v2):
    """Vectorized SAT: does the triangle (v0,v1,v2) overlap each box?

    centers: (N,3) float32 box centers; half: scalar float32 half-extent
    (cubical voxels); v0/v1/v2: (3,) float32.  Returns (N,) bool.

    Mirrors triBoxOverlap (VoxelBuilder.hpp:118-162): a box overlaps unless
    some axis separates.  Degenerate axes (L1 norm < 1e-8) never separate.
    """
    c = np.asarray(centers, dtype=np.float32).reshape(-1, 3)
    h = np.float32(half)
    v0 = np.asarray(v0, dtype=np.float32)
    v1 = np.asarray(v1, dtype=np.float32)
    v2 = np.asarray(v2, dtype=np.float32)

    p0 = v0 - c  # (N,3)
    p1 = v1 - c
    p2 = v2 - c

    e0 = p1 - p0
    e1 = p2 - p1
    e2 = p0 - p2

    # 1) the three box axes (aabbAxisSeparates, VoxelBuilder.hpp:88-103)
    mn = np.minimum(p0, np.minimum(p1, p2))
    mx = np.maximum(p0, np.maximum(p1, p2))
    sep = ((mn > h) | (mx < -h)).any(axis=1)

    # 2) nine edge-cross axes (axisSeparates, VoxelBuilder.hpp:73-86,136-154)
    def axis_sep(ax, ay, az, r):
        l1 = np.abs(ax) + np.abs(ay) + np.abs(az)
        d0 = p0[:, 0] * ax + p0[:, 1] * ay + p0[:, 2] * az
        d1 = p1[:, 0] * ax + p1[:, 1] * ay + p1[:, 2] * az
        d2 = p2[:, 0] * ax + p2[:, 1] * ay + p2[:, 2] * az
        tmin = np.minimum(d0, np.minimum(d1, d2))
        tmax = np.maximum(d0, np.maximum(d1, d2))
        return (l1 >= _EPS) & ((tmin > r) | (tmax < -r))

    zero = np.float32(0.0)
    for e in (e0, e1, e2):
        ex, ey, ez = e[:, 0], e[:, 1], e[:, 2]
        # L = e x X = (0, -ez, ey);  R = h*|Ly| + h*|Lz|
        sep |= axis_sep(zero, -ez, ey, h * np.abs(-ez) + h * np.abs(ey))
        # L = e x Y = (ez, 0, -ex)
        sep |= axis_sep(ez, zero, -ex, h * np.abs(ez) + h * np.abs(-ex))
        # L = e x Z = (-ey, ex, 0)
        sep |= axis_sep(-ey, ex, zero, h * np.abs(-ey) + h * np.abs(ex))

    # 3) triangle plane (planeSeparates, VoxelBuilder.hpp:104-115)
    n = np.cross(e0, e1).astype(np.float32)
    an = np.abs(n)
    nl1 = an.sum(axis=1)
    r = h * an[:, 0] + h * an[:, 1] + h * an[:, 2]
    s = (n * p0).sum(axis=1)
    sep |= (nl1 >= _EPS) & (np.abs(s) > r)

    return ~sep


class OracleResult:
    """Occupancy + bookkeeping matching the reference grid counters."""

    def __init__(self, occupancy, dims, origin, voxel_size, set_calls, hits):
        self.occupancy = occupancy  # (Z, Y, X) bool  [z-major like idx map]
        self.dims = dims            # (X, Y, Z) cell counts
        self.origin = origin        # float32 (3,)
        self.voxel_size = voxel_size
        #: number of setVoxel calls incl. duplicates — the reference's
        #: m_voxelSet counter (voxelgridBool.cpp:67) counts duplicates too.
        self.set_calls = set_calls
        #: (tri, x, y, z) rows in serial emission order (z, then y, then x
        #: innermost per triangle) — defines GridVec's duplicate-preserving
        #: AABB order (voxelgridVecEncoding.cpp:20-39).
        self.hits = hits


def oracle_voxelize(vertices, faces, voxel_size: float,
                    bb_min=None, bb_max=None) -> OracleResult:
    """Voxelize a triangle mesh exactly as the reference serial path does.

    vertices: (V,3) float32; faces: (F,3) int vertex indices;
    voxel_size: cube edge length.  Optional bb override (the reference
    always derives it from all vertices; tests may pin it).
    """
    v = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    f = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    vs = np.float32(voxel_size)
    half = np.float32(voxel_size * 0.5)

    if bb_min is None or bb_max is None:
        bb_min, bb_max = mesh_bbox(v)
    bb_min = np.asarray(bb_min, dtype=np.float32)
    bb_max = np.asarray(bb_max, dtype=np.float32)
    nx, ny, nz = grid_dims(bb_min, bb_max, vs)

    occ = np.zeros((nz, ny, nx), dtype=bool)
    set_calls = 0
    hit_rows: list[np.ndarray] = []

    if nx == 0 or ny == 0 or nz == 0 or len(f) == 0:
        return OracleResult(occ, (nx, ny, nz), bb_min, float(vs), 0,
                            np.zeros((0, 4), dtype=np.int64))

    tri = v[f]  # (F, 3, 3)
    for t in range(len(f)):
        v0, v1, v2 = tri[t, 0], tri[t, 1], tri[t, 2]
        tmin = np.minimum(v0, np.minimum(v1, v2))
        tmax = np.maximum(v0, np.maximum(v1, v2))

        # Window math from VoxelBuilder.hpp:175-184: float32 divide,
        # C truncation toward zero via int(), +2 slack on the end.
        xs = max(0, int((tmin[0] - bb_min[0]) / vs))
        ys = max(0, int((tmin[1] - bb_min[1]) / vs))
        zs = max(0, int((tmin[2] - bb_min[2]) / vs))
        xe = min(nx, int((tmax[0] - bb_min[0]) / vs) + 2)
        ye = min(ny, int((tmax[1] - bb_min[1]) / vs) + 2)
        ze = min(nz, int((tmax[2] - bb_min[2]) / vs) + 2)
        if xe <= xs or ye <= ys or ze <= zs:
            continue

        # Cell centers for the whole window, z-major to mirror the serial
        # loop nest (z outer, y, x inner).
        zi, yi, xi = np.meshgrid(
            np.arange(zs, ze), np.arange(ys, ye), np.arange(xs, xe),
            indexing="ij",
        )
        xi = xi.ravel()
        yi = yi.ravel()
        zi = zi.ravel()
        centers = np.stack(
            [
                bb_min[0] + (xi.astype(np.float32) + np.float32(0.5)) * vs,
                bb_min[1] + (yi.astype(np.float32) + np.float32(0.5)) * vs,
                bb_min[2] + (zi.astype(np.float32) + np.float32(0.5)) * vs,
            ],
            axis=-1,
        )
        hit = oracle_tri_box_overlap(centers, half, v0, v1, v2)
        k = int(hit.sum())
        if k:
            occ[zi[hit], yi[hit], xi[hit]] = True
            set_calls += k
            hit_rows.append(
                np.stack(
                    [np.full(k, t, dtype=np.int64), xi[hit], yi[hit], zi[hit]],
                    axis=-1,
                )
            )

    hits = (np.concatenate(hit_rows, axis=0) if hit_rows
            else np.zeros((0, 4), dtype=np.int64))
    return OracleResult(occ, (nx, ny, nz), bb_min, float(vs), set_calls, hits)
