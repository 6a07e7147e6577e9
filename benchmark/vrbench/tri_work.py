"""The work of the triangle accel's binning, counted from the benchmark's
own geometry and reference: the yardstick of `tri_bin_roofline_pct`.

The tri grid is worked out here from the geometry, never read from the
program: the triangle accel's rule (voxelray_torch/ops/tri_accel.py
_tri_grid, res by models/scene.py _tri_res), copied: `res` cells on the
longest axis of the vertex sets' union bounding box, res =
clip(round(F ** (1 / 2.2)), 16, 256) for F triangles, the box padded half
a cell on every side, dims ceil(extent / cell) in float32.

A binning has to read each triangle's corners, the vertex set (float32
x, y, z) and the faces (int32) once, test every cell of every
triangle's clamped window in that grid (reference.sat_tests, at
work.SAT_OPS float32 operations each), and write each (triangle, cell)
hit once (two int32, 8 bytes; reference.voxelize's set_calls over the
grid) and each cell's count once (int32).  A kernel that tests the
windows twice, or re-reads its inputs, does more: the share of the bound
counts what these inputs need.
"""
from __future__ import annotations

import numpy as np

from . import reference, work

__all__ = ["tri_res", "tri_grid", "bin_bound_s", "PAIR_BYTES",
           "CELL_BYTES"]

PAIR_BYTES = 8
CELL_BYTES = 4


def tri_res(n_faces):
    return int(np.clip(round(float(n_faces) ** (1 / 2.2)), 16, 256))


def tri_grid(geo):
    """(origin float32 (3,), cell size, dims) of the tri grid over the
    geometry's union box."""
    lo, hi = geo.bbox
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    vs = max(float(max(hi - lo)), 1e-6) / float(tri_res(len(geo.faces)))
    origin = lo - 0.5 * vs
    ext = ((hi + 0.5 * vs) - origin) / np.float32(vs)
    dims = tuple(int(x) for x in np.ceil(ext).astype(np.int64))
    return origin, vs, dims


def bin_bound_s(v, f, grid, device):
    """The least seconds a binning of vertex set v can take: the larger of
    its bytes over the HBM peak and its SAT tests over the float32 peak
    (module docstring)."""
    origin, vs, dims = grid
    tests = reference.sat_tests(v, f, origin, vs, dims, device)
    pairs = reference.voxelize(v, f, origin, vs, dims, device)[1]
    nbytes = 12 * len(v) + 12 * len(f) + PAIR_BYTES * pairs \
        + CELL_BYTES * dims[0] * dims[1] * dims[2]
    return max(nbytes / work.peak("hbm_bytes_per_s"),
               tests * work.SAT_OPS / work.peak("fp32_flops_per_s"))
