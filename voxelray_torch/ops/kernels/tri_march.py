"""tri_march: the tri-grid march of one triangle trace (csrc/tri_march.cu).

Replaces, on the triangle path, the lap loop that drives K3 and K4 (the
Pallas kernels voxelray_tpu/ops/pallas/grid_walk.py:496/:569 and
brick_fine.py:296, with the lap glue of voxelray_tpu/ops/tri_accel.py)
by one launch per trace: a lane holds a ray through round 0, its laps'
staged walks, the cell rows' Moller-Trumbore tests and the advances (a
long ray is deferred and taken on by a lane of another warp once the
other rays are started; a warp with few rays tests each row with all its
lanes).

`tri_march_plain` is the march (round 0, then laps; ops/tri_accel.py
states its semantics) as the lap loop over tensors: every lap one staged
trace (staged_march_plain, the lap loop over K3 and K4, which launches
them on CUDA tensors), the gather of each ray's cell row and
Moller-Trumbore over it.

CUDA tensors launch the kernel (`tri_march_cuda`); CPU tensors run
`tri_march_plain`, whose (t, id, u, v) the kernel gives bit for bit.
Each launch adds 1 to the counter `launches.tri_march` (utils/trace.py).
`march_args` builds a launch's argument block on any device, so the host
build of the kernel (tests/) runs the same blocks.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..geometry import div_scalar, floor_cell
from ..intersect import hit_triangles
from ._build import F, I, P, config, fields, launch, need, need_rays, on_cuda
from .staged_march import (_DRAIN_K, SMEM_WORDS, max_drain_laps, set_tables,
                           staged_march_plain, table_words)

__all__ = ["tri_march_plain", "tri_march_cuda", "march_args", "launch_config",
           "TriMarchArgs", "INNER_K"]

# ray-triangle pairs per Moller-Trumbore batch of the plain version:
# bounds the (m, L, 9) gathered rows and their temporaries at full-frame
# sizes
_PAIRS = 1 << 23
# candidate bricks the staged walk finds per ray in a lap's first K4 call
# (cost only: the cell it returns does not depend on it)
INNER_K = 2
# the schedule's counters, one 128-byte line each (csrc/tri_march.cu,
# kSchedWords)
_SCHED_WORDS = 4 * 32


class TriMarchArgs(ctypes.Structure):
    """csrc/tri_march.cu's TriMarchArgs."""
    SIZES = ("tri_march_sizes", 0)
    _fields_ = fields((P, "o d t_min t_max coarse"), (I, "coarse_words"),
                      (P, "l2"), (I, "l2_words"), (P, "fine"), (I, "nb"),
                      (P, "cell_slot cell_tris tri9 tri_origin"),
                      (I, "n nx ny nz bx by bz"),
                      (F, "ogx ogy ogz vs half bwf scale tri_vs tri_half"),
                      (I, "l_width k_first k_drain max_groups max_laps "
                           "smem_words"),
                      (P, "t_out id_out u_out v_out unresolved sched "
                           "deferred"))


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


def _add(work, key, count):
    if work is not None:
        work[key] = work.get(key, 0) + int(count)


def _mt_cell(ta, o, d, slot_rows, t_lo, span_hi, t_max, work=None):
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
        if work is not None:
            _add(work, "tests", (ids >= 0).sum())
            work["rows_seen"][slot_rows[r].long()] = True
            work["tris_seen"][ids[ids >= 0].long()] = True
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


def tri_march_plain(o, d, t_min, t_max, ta, two_level=None, work=None):
    """The march as tensor code.  o, d: (N, 3) float32; t_min, t_max: (N,)
    float32; ta: a TriAccel on their device; two_level: the staged walk's
    superbrick skip (None: use_two_level's default).  Returns (t, id, u,
    v, unresolved): t = +inf, id = -1, u = v = 0 on a miss; unresolved
    counts rays still active at the lap bound (0 by construction).

    work: a dict to which the march adds its own work on these rays:
    "laps" (ray-laps), "active" (the rays in each lap, a list),
    "ray_laps" (the laps of each ray), "rows" (cell rows tested), "tests"
    (ray-triangle tests), and the masks "rows_seen" and "tris_seen" of the
    cell rows and triangles read.
    """
    n, dev = o.shape[0], o.device
    nx, ny, nz = ta.dims
    n_cells = nx * ny * nz
    inf = float("inf")
    if work is not None:
        work.setdefault("rows_seen", torch.zeros(
            ta.cell_tris.shape[0], dtype=torch.bool, device=dev))
        work.setdefault("tris_seen", torch.zeros(
            ta.tri9.shape[0], dtype=torch.bool, device=dev))
        work.setdefault("ray_laps", torch.zeros(n, dtype=torch.int32,
                                                device=dev))
    best_t = torch.full((n,), inf, device=dev)
    best_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), device=dev)
    best_v = torch.zeros((n,), device=dev)

    # ---- round 0: the cell holding the start point o + d * t_min ------
    start = o + d * t_min[:, None]
    ocell = floor_cell(div_scalar(start - ta.origin,
                                  float(np.float32(ta.voxel_size)))).long()
    dims_t = torch.tensor([nx, ny, nz], device=dev)
    inside = ((ocell >= 0) & (ocell < dims_t)).all(dim=-1)
    olin = torch.clamp(ocell[:, 0] + nx * (ocell[:, 1] + ny * ocell[:, 2]),
                       0, n_cells - 1)
    oslot = torch.where(inside, ta.cell_slot[olin],
                        torch.full_like(olin, -1, dtype=torch.int32))
    i0 = torch.nonzero(oslot >= 0).squeeze(1)
    _add(work, "rows", i0.numel())
    _, t1_0 = _cell_span(olin[i0], o[i0], d[i0], ta)
    t0b, id0, u0, v0 = _mt_cell(ta, o[i0], d[i0], oslot[i0],
                                t_min[i0], t1_0 * (1 + 1e-6) + 1e-7,
                                t_max[i0], work)
    got = torch.isfinite(t0b)
    g = i0[got]
    best_t[g], best_id[g], best_u[g], best_v[g] = (t0b[got], id0[got],
                                                   u0[got], v0[got])

    # ---- laps: next nonempty cell, its triangle row, advance -----------
    t_cur = t_min.clone()
    unresolved_mask = torch.ones((n,), dtype=torch.bool, device=dev)
    unresolved_mask[g] = False
    act = torch.nonzero(unresolved_mask).squeeze(1)
    for _ in range(nx + ny + nz + 4):
        if act.numel() == 0:
            break
        _add(work, "laps", act.numel())
        if work is not None:
            work.setdefault("active", []).append(act.numel())
            work["ray_laps"][act] += 1
        t_cell, lin, _ = staged_march_plain(o[act], d[act], ta.brick,
                                            t_cur[act], t_max[act], None,
                                            INNER_K, two_level)
        sel = act[torch.isfinite(t_cell)]       # rays with no cell: misses
        linc = lin[torch.isfinite(t_cell)].long()
        oc, dc = o[sel], d[sel]
        t0c, t1c = _cell_span(linc, oc, dc, ta)
        slotc = torch.clamp(ta.cell_slot[linc], min=0)
        lo = torch.maximum(t_cur[sel], t0c * (1 - 1e-6) - 1e-7)
        _add(work, "rows", sel.numel())
        tc, idc, uc, vc = _mt_cell(ta, oc, dc, slotc, lo,
                                   t1c * (1 + 1e-6) + 1e-7, t_max[sel], work)
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
        act = s[t_cur[s] <= t_max[s]]
    return best_t, best_id, best_u, best_v, act.numel()


def march_args(o, d, t_min, t_max, ta, two_level=None, lanes=0):
    """(the argument block, (t, id, u, v, unresolved)) of the kernel's
    launch, arguments as tri_march_plain's, every tensor contiguous on o's
    device; the outputs allocated there (unresolved a zeroed (1,) int64),
    with the schedule's zeroed counters and, where the rays outnumber
    `lanes` (the lanes the launch holds at once), the zeroed deferred-ray
    slots, both on the block (`keep`)."""
    dev, n = o.device, o.shape[0]
    f32, i32, what = torch.float32, torch.int32, "tri_march_cuda"
    br = ta.brick
    nx, ny, nz = ta.dims
    bx, by, bz = br.bdims
    nb = br.fine.shape[1]
    a = TriMarchArgs(n=n, nb=nb, l_width=ta.l_width, k_first=INNER_K,
                     k_drain=_DRAIN_K, max_groups=max_drain_laps(br.bdims) + 1,
                     max_laps=nx + ny + nz + 4, smem_words=SMEM_WORDS)
    need_rays(a, what, o, d, t_min, t_max)
    set_tables(a, what, br, two_level, dev)
    a.cell_slot = need(what, "cell_slot", ta.cell_slot, dev, i32,
                       (nx * ny * nz + 1,))
    a.cell_tris = need(what, "cell_tris", ta.cell_tris, dev, i32,
                       (ta.cell_tris.shape[0], ta.l_width))
    a.tri9 = need(what, "tri9", ta.tri9, dev, f32, (ta.tri9.shape[0], 9))
    a.tri_origin = need(what, "origin", ta.origin, dev, f32, (3,))
    if tuple(br.dims) != (nx, ny, nz) or nx * ny * nz >= 2 ** 31:
        raise ValueError(f"{what}: brick accel dims {br.dims} do not fit "
                         f"the tri grid {ta.dims}")
    if a.coarse_words * 32 < bx * by * bz or nb < bx * by * bz:
        raise ValueError(f"{what}: brick tables too small for {br.bdims}")
    a.nx, a.ny, a.nz = nx, ny, nz
    tri_vs = np.float32(ta.voxel_size)
    a.tri_vs, a.tri_half = float(tri_vs), float(np.float32(0.5) * tri_vs)
    outs = (torch.empty((n,), dtype=f32, device=dev),
            torch.empty((n,), dtype=i32, device=dev),
            torch.empty((n,), dtype=f32, device=dev),
            torch.empty((n,), dtype=f32, device=dev),
            torch.zeros((1,), dtype=torch.int64, device=dev))
    (a.t_out, a.id_out, a.u_out, a.v_out,
     a.unresolved) = (x.data_ptr() for x in outs)
    a.keep = {"sched": torch.zeros((_SCHED_WORDS,), dtype=i32, device=dev)}
    if n > lanes:
        a.keep["deferred"] = torch.zeros((n, 4), dtype=i32, device=dev)
    for k, x in a.keep.items():
        setattr(a, k, x.data_ptr())
    return a, outs


def launch_config(ta, two_level=None, lib=None):
    """How the kernel launches on `ta` on its tables' device: {"chunk":
    the triangles a lane loads together from its own row, "share_slots":
    the positions of a shared row a lane stages per round, "share_lanes":
    the rays a warp holds at most when it shares their rows, "lap_budget":
    the laps after which a ray is deferred (0: never), "threads": a
    block's, "smem_bytes": its dynamic shared memory (the l2 and brick
    masks, then the shared rows' staging), "blocks_per_sm": the blocks a
    multiprocessor holds, "lanes": the rays the card holds at once},
    asked of the library once for each device and table size.  two_level:
    as tri_march_cuda's; lib: another build of csrc/tri_march.cu (default
    the kernel library)."""
    return dict(config("tri_march", ("chunk", "share_slots", "share_lanes",
                                      "lap_budget", "threads", "smem_bytes",
                                      "blocks_per_sm"),
                       table_words(ta.brick, two_level),
                       ta.brick.coarse.device.index, lib))


def tri_march_cuda(o, d, t_min, t_max, ta, two_level=None):
    """Launch the kernel; arguments and outputs as tri_march_plain, every
    tensor contiguous on one CUDA device.  unresolved comes back as a
    (1,) int64 tensor on the device (reading it waits for the kernel)."""
    on_cuda("tri_march_cuda", o.device)
    lanes = launch_config(ta, two_level)["lanes"] if o.shape[0] else 0
    a, outs = march_args(o, d, t_min, t_max, ta, two_level, lanes)
    if a.n:
        launch("tri_march", a, o.device)
    return outs
