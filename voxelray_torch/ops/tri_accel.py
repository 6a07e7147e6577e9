"""Triangle acceleration structure: uniform tri-grid + brick-walk march.

Counterpart of voxelray_tpu/ops/tri_accel.py, the JAX package's stand-in
for the reference's triangle BLAS (hello_vulkan.cpp:596-635): triangles
are binned SAT-exactly into a uniform grid whose nonempty-cell mask is a
BrickAccel, and rays march it with the staged brick walk (K3 + K4,
ops/traverse_fast.py with mega=False).

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

from ..utils.device import resolve_device
from .geometry import div_scalar, floor_cell, grid_dims
from .intersect import TMAX, TMIN, hit_triangles
from .traverse import _per_ray
from .traverse_fast import BrickAccel, build_accel, trace_grid_fast
from .voxelize import tri_cell_pairs

__all__ = ["TriAccel", "build_tri_accel", "trace_triangles_grid",
           "any_hit_triangles_grid"]

# ray-triangle pairs per Moller-Trumbore batch: bounds the (m, L, 9)
# gathered rows and their temporaries at full-frame sizes
_PAIRS = 1 << 23
# candidate bricks the staged walk finds per ray and lap (cost only)
_INNER_K = 2


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


def _cell_span(lin, o, d, ta):
    """(t_enter, t_exit) of cell `lin`'s box, reference slab float math."""
    nx, ny, _ = ta.dims
    vs = float(np.float32(ta.voxel_size))
    idx = torch.stack([lin % nx, (lin // nx) % ny, lin // (nx * ny)],
                      dim=-1).to(torch.float32)
    c = ta.origin + (idx + 0.5) * vs
    half = float(np.float32(0.5) * np.float32(vs))
    inv = 1.0 / d
    tb = inv * ((c - half) - o)
    tt = inv * ((c + half) - o)
    return (torch.minimum(tb, tt).amax(dim=-1),
            torch.maximum(tb, tt).amin(dim=-1))


def _mt_cell(ta, o, d, slot_rows, t_lo, span_hi, t_max):
    """Moller-Trumbore over one cell row per ray: (t, tri_id, u, v) of the
    nearest hit with t_lo < t <= span_hi (inclusive in-cell bound) and
    t < t_max (the brute trace's strict interval), t = +inf / id = -1 on
    none.  Ties inside the row go to the lowest id (ascending rows)."""
    m = o.shape[0]
    out_t = torch.full((m,), float("inf"), device=o.device)
    out_id = torch.full((m,), -1, dtype=torch.int32, device=o.device)
    out_u = torch.zeros((m,), device=o.device)
    out_v = torch.zeros((m,), device=o.device)
    step = max(1, _PAIRS // ta.l_width)
    pad = ta.tri9.shape[0] - 1
    for r0 in range(0, m, step):
        r = slice(r0, min(r0 + step, m))
        ids = ta.cell_tris[slot_rows[r].long()]               # (b, L)
        rows = ta.tri9[torch.where(ids >= 0, ids, pad).long()]
        t, u, v = hit_triangles(o[r, None, :], d[r, None, :], rows[..., 0:3],
                                rows[..., 3:6], rows[..., 6:9],
                                t_min=t_lo[r, None], t_max=t_max[r, None])
        t = torch.where((ids >= 0) & (t <= span_hi[r, None]), t,
                        torch.full_like(t, float("inf")))
        arg = torch.argmin(t, dim=1, keepdim=True)
        tb = t.gather(1, arg)[:, 0]
        out_t[r] = tb
        out_id[r] = torch.where(torch.isfinite(tb), ids.gather(1, arg)[:, 0],
                                torch.full_like(out_id[r], -1))
        out_u[r] = u.gather(1, arg)[:, 0]
        out_v[r] = v.gather(1, arg)[:, 0]
    return out_t, out_id, out_u, out_v


def trace_triangles_grid(origins, dirs, ta: TriAccel, t_min=TMIN,
                         t_max=TMAX, return_stats=False):
    """Nearest triangle hit via the tri-grid march.

    Same contract as ops.traverse.trace_triangles_brute: (t, prim_id, u,
    v), t = +inf / id = -1 on a miss.  return_stats=True also returns
    `unresolved` (0 = every ray ran to its end).
    """
    batch = origins.shape[:-1]
    dev = origins.device
    o = origins.reshape(-1, 3).to(torch.float32).contiguous()
    d = dirs.reshape(-1, 3).to(torch.float32).contiguous()
    n = o.shape[0]
    t_min_b = _per_ray(t_min, n, dev).contiguous()
    t_max_b = _per_ray(t_max, n, dev).contiguous()
    nx, ny, nz = ta.dims
    n_cells = nx * ny * nz
    inf = float("inf")
    best_t = torch.full((n,), inf, device=dev)
    best_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), device=dev)
    best_v = torch.zeros((n,), device=dev)

    # ---- round 0: the cell holding the start point o + d * t_min ------
    start = o + d * t_min_b[:, None]
    ocell = floor_cell(div_scalar(start - ta.origin,
                                  float(np.float32(ta.voxel_size)))).long()
    dims_t = torch.tensor([nx, ny, nz], device=dev)
    inside = ((ocell >= 0) & (ocell < dims_t)).all(dim=-1)
    olin = torch.clamp(ocell[:, 0] + nx * (ocell[:, 1] + ny * ocell[:, 2]),
                       0, n_cells - 1)
    oslot = torch.where(inside, ta.cell_slot[olin],
                        torch.full_like(olin, -1, dtype=torch.int32))
    i0 = torch.nonzero(oslot >= 0).squeeze(1)
    _, t1_0 = _cell_span(olin[i0], o[i0], d[i0], ta)
    t0b, id0, u0, v0 = _mt_cell(ta, o[i0], d[i0], oslot[i0],
                                t_min_b[i0], t1_0 * (1 + 1e-6) + 1e-7,
                                t_max_b[i0])
    got = torch.isfinite(t0b)
    g = i0[got]
    best_t[g], best_id[g], best_u[g], best_v[g] = (t0b[got], id0[got],
                                                   u0[got], v0[got])

    # ---- laps: next nonempty cell, its triangle row, advance -----------
    t_cur = t_min_b.clone()
    unresolved_mask = torch.ones((n,), dtype=torch.bool, device=dev)
    unresolved_mask[g] = False
    act = torch.nonzero(unresolved_mask).squeeze(1)
    for _ in range(nx + ny + nz + 4):
        if act.numel() == 0:
            break
        t_cell, lin = trace_grid_fast(o[act], d[act], ta.brick,
                                      t_min=t_cur[act], t_max=t_max_b[act],
                                      mega=False, k_hits=_INNER_K)
        sel = act[torch.isfinite(t_cell)]       # rays with no cell: misses
        linc = lin[torch.isfinite(t_cell)].long()
        oc, dc = o[sel], d[sel]
        t0c, t1c = _cell_span(linc, oc, dc, ta)
        slotc = torch.clamp(ta.cell_slot[linc], min=0)
        lo = torch.maximum(t_cur[sel], t0c * (1 - 1e-6) - 1e-7)
        tc, idc, uc, vc = _mt_cell(ta, oc, dc, slotc, lo,
                                   t1c * (1 + 1e-6) + 1e-7, t_max_b[sel])
        got = torch.isfinite(tc)
        g = sel[got]
        best_t[g], best_id[g], best_u[g], best_v[g] = (tc[got], idc[got],
                                                       uc[got], vc[got])
        # advance to the tested cell's midpoint, never backward: adjacent
        # cells compute their shared face from different float
        # expressions, so the next cell's entry can undershoot this exit
        # by a few ulp; the midpoint is past this cell's entry and half a
        # span short of the next one's
        miss = ~got
        s = sel[miss]
        mid = 0.5 * (t0c[miss] + t1c[miss])
        t_cur[s] = torch.where(mid > t_cur[s], mid, torch.nextafter(
            t_cur[s], torch.full_like(mid, inf)))
        act = s[t_cur[s] <= t_max_b[s]]
    out = (best_t.reshape(batch), best_id.reshape(batch),
           best_u.reshape(batch), best_v.reshape(batch))
    if return_stats:
        return out + (act.numel(),)
    return out


def any_hit_triangles_grid(origins, dirs, ta: TriAccel, t_min=TMIN,
                           t_max=TMAX):
    """Occlusion predicate (shadow rays) via the tri-grid march."""
    t, _, _, _ = trace_triangles_grid(origins, dirs, ta, t_min=t_min,
                                      t_max=t_max)
    return torch.isfinite(t)
