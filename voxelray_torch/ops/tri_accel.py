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

Cells with more triangles than the row width are truncated and counted
in `overflow_cells` (build_scene retries wider, then falls back to the
brute trace).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..utils import trace
from ..utils.device import resolve_device
from .geometry import grid_dims
from .intersect import TMAX, TMIN
from .kernels.tri_march import tri_march_cuda, tri_march_plain
from .traverse import _per_ray
from .traverse_fast import BrickAccel, build_accel
from .voxelize import tri_cell_pairs

__all__ = ["TriAccel", "build_tri_accel", "trace_triangles_grid",
           "any_hit_triangles_grid"]


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


@trace.spanned("build_tri_accel")
def build_tri_accel(v0, v1, v2, *, res=64, l_width=None, max_l_width=512,
                    device=None) -> TriAccel:
    """Bin triangles (three (F, 3) corner arrays) into a uniform grid whose
    longest axis has ~`res` cells, on `device` (default: the CUDA card).

    The grid, the padding and the row layout are the JAX package's:
    rows list a cell's triangles in ascending id (the brute trace's
    lowest-index tie rule), l_width defaults to the widest cell capped
    at max_l_width.
    """
    dev = resolve_device(device)
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    f_total = len(v0)
    tri_all = np.stack([v0, v1, v2], axis=1)          # (F, 3, 3)
    bb_min = tri_all.reshape(-1, 3).min(axis=0)
    bb_max = tri_all.reshape(-1, 3).max(axis=0)
    extent = float(max(bb_max - bb_min))
    vs = max(extent, 1e-6) / float(res)
    # pad the box a hair so max-boundary triangles stay inside windows
    bb_min = bb_min - 0.5 * vs
    bb_max = bb_max + 0.5 * vs
    dims = grid_dims(bb_min, bb_max, vs)
    nx, ny, nz = dims
    n_cells = nx * ny * nz

    tri_t = torch.as_tensor(tri_all, device=dev)
    pair_tri, pair_lin = tri_cell_pairs(tri_t, bb_min, vs, dims)
    counts = torch.bincount(pair_lin, minlength=n_cells)
    nonempty = torch.nonzero(counts).squeeze(1)
    n_ne = int(nonempty.numel())
    true_max = int(counts.max()) if n_ne else 1
    if l_width is None:
        l_width = min(true_max, max_l_width)
    l_width = max(1, int(l_width))
    overflow = int((counts > l_width).sum())

    cell_slot = torch.full((n_cells + 1,), -1, dtype=torch.int32, device=dev)
    cell_slot[nonempty] = torch.arange(n_ne, dtype=torch.int32, device=dev)
    cell_tris = torch.full((max(1, n_ne), l_width), -1, dtype=torch.int32,
                           device=dev)
    off = torch.zeros((n_cells + 1,), dtype=torch.int64, device=dev)
    off[1:] = torch.cumsum(counts, 0)
    within = torch.arange(pair_lin.numel(), device=dev) - off[pair_lin]
    keep = within < l_width
    cell_tris[cell_slot[pair_lin[keep]].long(), within[keep]] = \
        pair_tri[keep].to(torch.int32)

    occ = (counts > 0).to(torch.uint8).reshape(nz, ny, nx)
    brick = build_accel(occ, bb_min, vs)
    tri9 = torch.cat([tri_t.reshape(f_total, 9),
                      torch.zeros((1, 9), device=dev)])   # degenerate pad
    return TriAccel(
        brick=brick, cell_slot=cell_slot, cell_tris=cell_tris, tri9=tri9,
        origin=torch.as_tensor(bb_min.astype(np.float32), device=dev),
        dims=dims, voxel_size=float(vs), l_width=l_width,
        overflow_cells=overflow)


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
