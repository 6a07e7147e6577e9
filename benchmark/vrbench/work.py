"""The work of a trace and of a voxelize, counted from the benchmark's own
inputs and reference: the yardsticks of `trace_roofline_pct` and
`voxelize_roofline_pct`.

A trace kernel has to read each ray it traces, its origin and direction
(six float32, 24 bytes), and write its answer once (the hit t as float32
and the hit id as int32, 8 bytes).  The rays of a frame are its W x H
primary rays and the shadow rays of the pixels that hit something facing
the light, as the reference (reference.py) admits them for that frame's
camera.  The count comes from the inputs and the reference and never
from the program, so it is the same work whatever implements the trace.

It is a lower bound on the bytes any trace moves: it leaves out the
scene (the grid's bricks and words, or the triangles and their cell
rows), which every ray also reads, and counts each ray once however
often a kernel re-reads it.  A share of the bandwidth peak computed from
it therefore never passes 100% unless the kernel time leaves out part of
the work.
"""
from __future__ import annotations

import json
from pathlib import Path

__all__ = ["RAY_BYTES", "SAT_OPS", "trace_rays", "trace_bytes",
           "voxelize_bound_s", "peak"]

RAY_BYTES = 24 + 8
# float32 operations of one (triangle, cell) test of the reference's
# voxelize (reference._sat and the cell's centre), each value computed
# once, no operation on the constant zero component of an edge axis, sign
# flips and the boolean ors not counted:
#   p0, p1, p2 = v - c (9), edges e0, e1, e2 (9), the box test's min and
#     max (12) and compares (6)                                    36
#   each of the 9 edge axes: r = h|a| + h|b| (2 abs, 2 mul, 1 add), l1
#     from the same abs (1 add), three projections (2 mul, 1 add each),
#     their min and max (4), tmin > r, tmax < -r, l1 >= eps (3)     9 x 22
#   the normal: its 3 components (2 mul, 1 sub each), l1 (3 abs, 2 add),
#     r (3 mul, 2 add), s = n . p0 (3 mul, 2 add), |s| > r and l1 >= eps
#     (1 abs, 2 compares)                                          27
#   the cell's centre, origin + (cell + 0.5) * vs (3 a coordinate)  9
# Every test is counted whole, as the reference evaluates it: a kernel
# that stops at the first separating axis does less.
SAT_OPS = 36 + 9 * 22 + 27 + 9
PEAKS = Path(__file__).resolve().parent / "peaks.json"


def trace_rays(width, height, admitted):
    """Rays traced over frames of width x height with `admitted` shadow
    rays each (a list, one count a frame)."""
    return len(admitted) * width * height + sum(admitted)


def trace_bytes(width, height, admitted):
    return RAY_BYTES * trace_rays(width, height, admitted)


def voxelize_bound_s(n_vertices, n_faces, cells, tests):
    """The least seconds a voxelize can take: the larger of its bytes (the
    vertex set, float32 x, y, z, and the faces, int32, read once; the
    occupancy, a byte a cell as the reference holds it, written once) over
    the HBM peak, and of its `tests` SAT tests (reference.sat_tests) at
    SAT_OPS each over the float32 peak."""
    nbytes = 12 * n_vertices + 12 * n_faces + cells
    return max(nbytes / peak("hbm_bytes_per_s"),
               tests * SAT_OPS / peak("fp32_flops_per_s"))


def peak(name):
    """A peak of the table (peaks.json): value and unit."""
    table = json.loads(PEAKS.read_text())
    return table[name]["value"]
