"""Triangle acceleration structure: uniform tri-grid + brick-walk march.

Counterpart of voxelray_tpu/ops/tri_accel.py, the JAX package's stand-in
for the reference's triangle BLAS (hello_vulkan.cpp:596-635): triangles
are binned SAT-exactly into a uniform grid whose nonempty-cell mask is a
BrickAccel, and rays march it (ops/kernels/tri_march.py): on the card one
kernel launch per trace, on the CPU the plain lap loop over the staged
brick walk.

Trace = round 0 (the triangles of the cell holding the ray's start
point o + d * t_min: the grid trace's accept rule t0 >= t_min never
reports that cell), then laps of (next nonempty cell after t_cur via the
staged walk) -> (Moller-Trumbore over the cell's triangle row, accepting
only hits inside the cell's t-span, so nearest ordering survives
triangles spanning cells) -> (rays without an in-span hit advance t_cur
to the tested cell's t-midpoint and march on).

Two faults of the JAX march are repaired here.  Its round 0 tests the
cell holding the origin o; a ray whose origin lies within t_min of that
cell's exit (a shadow ray leaving a surface near a cell face) enters the
next cell before t_min, the walk never reports that cell, and its hits
are lost: here round 0 tests the cell holding o + d * t_min.  And a cell
crossed at an edge has t0 == t1, so its midpoint does not move t_cur and
the walk would return the same cell until the lap bound: here t_cur then
moves one float up.

The JAX package caps how many rays each lap serves (walk_frac,
cand_frac) to bound TPU buffers; here every active ray is served every
lap, which gives the same result with nothing starved.  Each lap moves a
ray to a nonempty cell strictly farther along it, so the laps are bounded
by the grid's step bound; `unresolved` counts rays left at that bound
and is 0 by construction.

`plan_tri_accel` / `build_tri_accel_planned` build the accel from a
vertex array: the faces and the grid are set once, and on the card each
build's tables are written by the tri_bin kernels (ops/kernels/tri_bin.py:
a counting sort of the binning's hits into the rows) with one host sync.
Rows are never cut there: a cell wider than the widest row (L_WIDTHS)
gives no accel, and the scene takes the brute trace.  Both triangle
scenes build this way: build_scene once over its triangles' own box,
build_scene_planned each step of a deforming mesh.  `build_tri_accel`,
the JAX package's build (its rows cut at l_width, the cut cells counted
in `overflow_cells`), bins the same way: on the card its rows are written
as wide as the widest cell and then cut (or padded) to its l_width.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..utils import trace
from ..utils.device import resolve_device
from .geometry import grid_dims
from .intersect import TMAX, TMIN
from .kernels import tri_bin
from .kernels.tri_march import tri_march_cuda, tri_march_plain
from .traverse import _per_ray
from .traverse_fast import BrickAccel, build_accel
from .voxelize import tri_cell_pairs

__all__ = ["TriAccel", "build_tri_accel", "TriAccelPlan", "plan_tri_accel",
           "build_tri_accel_planned", "trace_triangles_grid",
           "any_hit_triangles_grid", "L_WIDTHS"]

# the row width's caps: the widest cell up to the first, else (a retry) up
# to the second; a cell wider still takes the brute trace
L_WIDTHS = (512, 4096)


@dataclass(frozen=True)
class TriAccel:
    brick: BrickAccel       # walkable mask of nonempty tri-cells
    cell_slot: Any          # int32[n_cells+1]: lin -> row of cell_tris, -1
    cell_tris: Any          # int32[n_rows, L]: tri ids ascending, -1 = pad
    tri9: Any               # float32[F+1, 9]: v0|v1|v2 rows (row F = pad)
    origin: Any             # float32[3] tensor
    dims: tuple
    voxel_size: float
    l_width: int
    overflow_cells: int


def _tri_grid(bb_min, bb_max, res):
    """The tri grid over a box: ~`res` cells on its longest axis and the
    box padded half a cell on every side, so that max-boundary triangles
    stay inside windows.  Returns (origin float32 (3,), cell size, dims)."""
    bb_min = np.asarray(bb_min, np.float32)
    bb_max = np.asarray(bb_max, np.float32)
    extent = float(max(bb_max - bb_min))
    vs = max(extent, 1e-6) / float(res)
    lo = bb_min - 0.5 * vs
    return lo, vs, grid_dims(lo, bb_max + 0.5 * vs, vs)


def _use_kernel(device):
    """Whether the tables come from the tri_bin kernels (CUDA tensors) or
    from the plain hit stream, ops/voxelize.tri_cell_pairs (any other
    device, and the kernels' reference on the card)."""
    return device.type == "cuda"


def _bin(tri9, n_tri, origin, vs, dims, box, widths):
    """Bin the triangles (the first n_tri rows of tri9) into the grid:
    (cell_slot, the nonempty cells' uint8 mask, the sizes, and a function
    rows(n_rows, l_width) -> cell_tris, each cell's row cut at l_width).

    The sizes are the one device-to-host copy: {pairs, nonempty cells,
    widest cell, the cells wider than widths[0] (over0) and than widths[1]
    (over1), the triangles outside the box, the rows longer than the rows
    pass's warp path (wide)}, tri_bin.SIZES.  On the card the kernels write
    the tables, each row as wide as the widest cell, then cut or padded
    with -1 to l_width."""
    if _use_kernel(tri9.device):
        with trace.span("tri_bin"):
            cell_count, sizes = tri_bin.count(tri9, n_tri, origin, vs, dims,
                                              *box)
            cell_slot, mask = tri_bin.cells(cell_count, sizes, widths)
        sizes = dict(zip(tri_bin.SIZES, sizes.tolist()))

        def rows(n_rows, l_width):
            full = max(1, sizes["widest"])
            with trace.span("tri_bin"):
                cell_tris = tri_bin.rows(tri9, n_tri, origin, vs, dims,
                                         cell_slot, n_rows, full,
                                         sizes["wide"])
            if l_width == full:
                return cell_tris
            if l_width < full:
                return cell_tris[:, :l_width].contiguous()
            return torch.nn.functional.pad(cell_tris, (0, l_width - full),
                                           value=-1)
        return cell_slot, mask, sizes, rows
    p_tri, p_lin = tri_cell_pairs(tri9[:n_tri].reshape(n_tri, 3, 3), origin,
                                  vs, dims)
    n_cells = dims[0] * dims[1] * dims[2]
    cell_count = torch.bincount(p_lin, minlength=n_cells).to(torch.int32)
    sizes = tri_bin.sizes_plain(tri9, n_tri, *box)
    cell_slot, mask = tri_bin.cells_plain(cell_count, sizes, widths)
    return (cell_slot, mask, dict(zip(tri_bin.SIZES, sizes.tolist())),
            lambda n_rows, l_width: tri_bin.rows_plain(
                p_tri, p_lin, cell_slot, n_rows, l_width))


def _accel(tri9, origin, vs, dims, cell_slot, mask, cell_tris, l_width,
           overflow):
    """The TriAccel of the tables, and the brick accel of the nonempty
    cells (no fine_sb: tri_march walks the staged walk's tables)."""
    nx, ny, nz = dims
    brick = build_accel(mask.reshape(nz, ny, nx), origin, vs, fine_sb=False)
    return TriAccel(brick=brick, cell_slot=cell_slot, cell_tris=cell_tris,
                    tri9=tri9, origin=brick.origin, dims=dims,
                    voxel_size=float(vs), l_width=l_width,
                    overflow_cells=overflow)


def _record(sizes, l_width, overflow, wide):
    n_ne = sizes["nonempty"]
    trace.count("tri_accel.pairs", sizes["pairs"])
    trace.count("tri_accel.row_slots", max(1, n_ne) * l_width)
    trace.count("tri_accel.nonempty_cells", n_ne)
    trace.count("tri_accel.overflow_cells", overflow)
    trace.count("tri_accel.outside", sizes["outside"])
    trace.count("tri_accel.wide_rows", wide)


@trace.spanned("build_tri_accel")
def build_tri_accel(v0, v1, v2, *, res=64, l_width=None, max_l_width=512,
                    device=None) -> TriAccel:
    """Bin triangles (three (F, 3) corner arrays) into a uniform grid over
    their bounding box whose longest axis has ~`res` cells, on `device`
    (default: the CUDA card).

    The JAX package's build: its grid, padding and row layout, rows
    listing a cell's triangles in ascending id (the brute trace's
    lowest-index tie rule), l_width defaulting to the widest cell capped
    at max_l_width; cells wider than l_width are cut and counted in
    `overflow_cells`.  The scenes build through build_tri_accel_planned,
    which never cuts a row.
    """
    dev = resolve_device(device)
    tri_all = np.stack([np.asarray(v0, np.float32),
                        np.asarray(v1, np.float32),
                        np.asarray(v2, np.float32)], axis=1)   # (F, 3, 3)
    f_total = len(tri_all)
    box = (tri_all.reshape(-1, 3).min(axis=0),
           tri_all.reshape(-1, 3).max(axis=0))
    origin, vs, dims = _tri_grid(*box, res)
    tri9 = torch.cat([torch.as_tensor(tri_all.reshape(f_total, 9),
                                      device=dev),
                      torch.zeros((1, 9), device=dev)])    # degenerate pad
    # the cut: l_width where given, else the widest cell up to max_l_width
    cut = max(1, int(max_l_width if l_width is None else l_width))
    cell_slot, mask, sizes, rows = _bin(tri9, f_total, origin, vs, dims, box,
                                        (cut, cut))
    l_width = cut if l_width is not None else max(
        1, min(sizes["widest"], max_l_width))
    overflow = sizes["over0"]
    _record(sizes, l_width, overflow, sizes["wide"])
    return _accel(tri9, origin, vs, dims, cell_slot, mask,
                  rows(max(1, sizes["nonempty"]), l_width), l_width,
                  overflow)


class TriAccelPlan:
    """The triangle accel of a mesh whose topology stays fixed, set up once
    for a build a step (the pattern of ops/voxelize.VoxelizePlan): a
    deforming mesh, or a static one built once over its own box.

    faces: (F, 3) indices into a vertex array of n_vertices rows, checked
    once on the host and kept on `device` (default: the CUDA card).  The
    tri grid is build_tri_accel's rule over the box bb_min..bb_max with
    `res` cells on its longest axis, fixed for every step: the box is the
    caller's promise that every step's vertices lie in it (the union box
    of an animation).  A triangle that leaves it is binned into the
    cells of its window clamped to the grid, so the accel may miss its
    hits; each step counts such triangles (`tri_accel.outside`).  Rows
    are never cut: l_width is the widest cell up to L_WIDTHS[0], else up
    to L_WIDTHS[1], and where a cell is wider still the step returns None
    (the brute trace), its overflow counted.
    """

    def __init__(self, faces, n_vertices, *, bb_min, bb_max, res,
                 device=None):
        f = np.asarray(faces).reshape(-1, 3)
        if len(f) and (f.min() < 0 or f.max() >= n_vertices):
            raise ValueError("faces index a vertex out of range")
        self.device = resolve_device(device)
        self.box = (np.asarray(bb_min, np.float32),
                    np.asarray(bb_max, np.float32))
        self.res = int(res)
        self.origin, self.voxel_size, self.dims = _tri_grid(*self.box,
                                                            self.res)
        self.n_triangles, self.n_vertices = len(f), int(n_vertices)
        if self.device.type == "cuda":
            tri_bin.check_sizes(self.dims, self.n_triangles)
        self.corners = torch.as_tensor(f.reshape(-1).astype(np.int64),
                                       device=self.device)
        self.pad = torch.zeros((1, 9), device=self.device)

    def tri9(self, vertices):
        """The (F + 1, 9) triangle table of (V, 3) float32 vertices on the
        plan's device: each face's corners, then the zero pad row."""
        return torch.cat([vertices[self.corners].reshape(-1, 9), self.pad])


def plan_tri_accel(faces, n_vertices, **kw) -> TriAccelPlan:
    return TriAccelPlan(faces, n_vertices, **kw)


@trace.spanned("build_tri_accel_planned")
def build_tri_accel_planned(plan: TriAccelPlan, vertices, tri9=None):
    """The plan's accel over (possibly deformed) vertices, or None (with a
    warning) where a cell is wider than L_WIDTHS[1].  Over the vertices'
    own box it equals build_tri_accel at the same res, table for table
    (at max_l_width L_WIDTHS[1] where a cell is wider than L_WIDTHS[0]).

    vertices: (V, 3) float32, numpy or a tensor (numpy is copied to the
    device first); tri9: the plan's triangle table of these vertices
    (TriAccelPlan.tri9) where the caller has it.  On the card the tri_bin
    kernels write the tables, and the step syncs once: one copy of the
    sizes (pairs, nonempty cells, widest cell, overflows, triangles
    outside the box, rows longer than the rows pass's warp path), which
    also feed the counters tri_accel.pairs, row_slots (rows x l_width),
    nonempty_cells, overflow_cells, outside and wide_rows (the rows the
    wide path orders; 0 where the step returns None).
    """
    if tri9 is None:
        v = torch.as_tensor(vertices, dtype=torch.float32,
                            device=plan.device).reshape(-1, 3)
        if v.shape[0] != plan.n_vertices:
            raise ValueError(f"{v.shape[0]} vertices; the plan has "
                             f"{plan.n_vertices}")
        tri9 = plan.tri9(v)
    cell_slot, mask, sizes, rows = _bin(tri9, plan.n_triangles, plan.origin,
                                        plan.voxel_size, plan.dims, plan.box,
                                        L_WIDTHS)
    over = sizes["over0"]
    l_width = max(1, min(sizes["widest"],
                         L_WIDTHS[1] if over else L_WIDTHS[0]))
    overflow = sizes["over1"] if over else 0
    if overflow:
        _record(sizes, l_width, overflow, 0)
        logging.getLogger(__name__).warning(
            "tri accel: %d cells outgrow l_width %d; using exact brute "
            "triangle traversal", overflow, L_WIDTHS[1])
        return None
    _record(sizes, l_width, 0, sizes["wide"])
    return _accel(tri9, plan.origin, plan.voxel_size, plan.dims, cell_slot,
                  mask, rows(max(1, sizes["nonempty"]), l_width), l_width, 0)


def trace_triangles_grid(origins, dirs, ta: TriAccel, t_min=TMIN,
                         t_max=TMAX, return_stats=False):
    """Nearest triangle hit via the tri-grid march.

    Same contract as ops.traverse.trace_triangles_brute: (t, prim_id, u,
    v), t = +inf / id = -1 on a miss.  return_stats=True also returns
    `unresolved` (0 = every ray ran to its end).  CUDA tensors take the
    march kernel (one launch), CPU tensors the plain lap loop.
    """
    batch = origins.shape[:-1]
    dev = origins.device
    o = origins.reshape(-1, 3).to(torch.float32).contiguous()
    d = dirs.reshape(-1, 3).to(torch.float32).contiguous()
    n = o.shape[0]
    t_min_b = _per_ray(t_min, n, dev).contiguous()
    t_max_b = _per_ray(t_max, n, dev).contiguous()
    if dev.type == "cuda":
        march = tri_march_cuda
    elif dev.type == "cpu":
        march = tri_march_plain
    else:
        raise ValueError(f"trace_triangles_grid: unsupported device {dev}")
    trace.count("rays.tri_march", n)
    with trace.span("tri_march"):
        *out, unresolved = march(o, d, t_min_b, t_max_b, ta)
    out = tuple(x.reshape(batch) for x in out)
    if return_stats:
        return out + (int(unresolved),)
    return out


def any_hit_triangles_grid(origins, dirs, ta: TriAccel, t_min=TMIN,
                           t_max=TMAX):
    """Occlusion predicate (shadow rays) via the tri-grid march."""
    t, _, _, _ = trace_triangles_grid(origins, dirs, ta, t_min=t_min,
                                      t_max=t_max)
    return torch.isfinite(t)
