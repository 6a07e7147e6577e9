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
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..geometry import div_scalar, floor_cell
from ..intersect import hit_triangles
from . import brick_fine
from ...utils import trace
from ._build import check, load_library
from .staged_march import (_DRAIN_K, max_drain_laps, staged_march_plain,
                           use_two_level)

__all__ = ["tri_march_plain", "tri_march_cuda", "launch_config", "INNER_K"]

# ray-triangle pairs per Moller-Trumbore batch of the plain version:
# bounds the (m, L, 9) gathered rows and their temporaries at full-frame
# sizes
_PAIRS = 1 << 23
# candidate bricks the staged walk finds per ray in a lap's first K4 call
# (cost only: the cell it returns does not depend on it)
INNER_K = 2
# shared memory for the superbrick and brick masks (the kernel's row
# staging comes on top): the 48 KB a block gets without opting in; the
# brick mask is read from global memory when both do not fit
SMEM_WORDS = 48 * 1024 // 4
# the schedule's counters, one 128-byte line each (csrc/tri_march.cu,
# kSchedWords)
_SCHED_WORDS = 4 * 32


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


def _launch_args(o, d, t_min, t_max, ta, l2, outs, lanes=0):
    """tri_march_launch's arguments but the stream, in order, tensors as
    tensors: inputs, the tables of `ta` (l2 None: single level), the grid
    constants, the plain march's step bounds, the outputs `outs` (t, id,
    u, v, unresolved), then the schedule's zeroed counters and
    deferred-ray slots (allocated here, on o's device; None, no ray
    deferred, where the rays do not outnumber `lanes`, the lanes the
    launch holds at once)."""
    n = o.shape[0]
    br = ta.brick
    og, vs, half, bwf, scale = brick_fine._consts(br.origin_key,
                                                  br.voxel_size, br.bdims)
    tri_vs = np.float32(ta.voxel_size)
    return (o, d, t_min, t_max, br.coarse, br.coarse.numel(), l2,
            0 if l2 is None else l2.numel(), br.fine, br.fine.shape[1],
            ta.cell_slot, ta.cell_tris, ta.tri9, ta.origin, n,
            *ta.dims, *br.bdims, *map(float, og), float(vs), float(half),
            float(bwf), float(scale), float(tri_vs),
            float(np.float32(0.5) * tri_vs), ta.l_width, INNER_K, _DRAIN_K,
            max_drain_laps(br.bdims) + 1, sum(ta.dims) + 4, SMEM_WORDS,
            *outs,
            torch.zeros((_SCHED_WORDS,), dtype=torch.int32, device=o.device),
            torch.zeros((n, 4), dtype=torch.int32, device=o.device)
            if n > lanes else None)


def _lib(lib=None):
    """tri_march_launch of the kernel library (or of `lib`, a build of
    csrc/tri_march.cu alone) with its argument types."""
    fn = (lib or load_library()).tri_march_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([vp] * 5 + [ci] + [vp] + [ci] + [vp] + [ci] + [vp] * 4
                   + [ci] * 7 + [cf] * 9 + [ci] * 6 + [vp] * 8)
    fn.restype = ci
    return fn


def launch_config(ta, lib=None, two_level=None):
    """How the kernel launches on `ta` with the current device: {"chunk":
    the triangles a lane loads together from its own row, "share_slots":
    the positions of a shared row a lane stages per round, "share_lanes":
    the rays a warp holds at most when it shares their rows, "lap_budget":
    the laps after which a ray is deferred (0: never), "threads": a
    block's, "smem_bytes": its dynamic shared memory (the l2 and brick
    masks, then the shared rows' staging), "blocks_per_sm": the blocks a
    multiprocessor holds, "lanes": the rays the card holds at once}.  lib:
    another build of csrc/tri_march.cu (default the kernel library);
    two_level: as tri_march_cuda's."""
    br = ta.brick
    l2_words = br.l2.numel() if use_two_level(br, two_level) else 0
    coarse = br.coarse.numel()
    table_words = l2_words + (coarse if l2_words + coarse <= SMEM_WORDS
                              else 0)
    fn = (lib or load_library()).tri_march_config
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    check(fn(table_words, out), "tri_march_config")
    cfg = dict(zip(("chunk", "share_slots", "share_lanes", "lap_budget",
                    "threads", "smem_bytes", "blocks_per_sm"), out))
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    cfg["lanes"] = cfg["threads"] * cfg["blocks_per_sm"] * sms
    return cfg


def _check(name, x, dev, dtype, shape):
    if not x.is_cuda or x.device != dev:
        raise ValueError(f"tri_march_cuda: {name} not on {dev}")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"tri_march_cuda: {name} must be {dtype} "
                         f"{tuple(shape)}, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"tri_march_cuda: {name} not contiguous")


def tri_march_cuda(o, d, t_min, t_max, ta, two_level=None, lib=None):
    """Launch the kernel; arguments and outputs as tri_march_plain, every
    tensor contiguous on one CUDA device.  unresolved comes back as a
    (1,) int64 tensor on the device (reading it waits for the kernel).
    lib: another build of csrc/tri_march.cu (default the kernel
    library)."""
    dev = o.device
    n = o.shape[0]
    f32, i32 = torch.float32, torch.int32
    br = ta.brick
    nx, ny, nz = ta.dims
    bx, by, bz = br.bdims
    nb = br.fine.shape[1]
    for name, x, dtype, shape in (
            ("o", o, f32, (n, 3)), ("d", d, f32, (n, 3)),
            ("t_min", t_min, f32, (n,)), ("t_max", t_max, f32, (n,)),
            ("coarse", br.coarse, i32, br.coarse.shape),
            ("fine", br.fine, i32, (16, nb)),
            ("cell_slot", ta.cell_slot, i32, (nx * ny * nz + 1,)),
            ("cell_tris", ta.cell_tris, i32, (ta.cell_tris.shape[0],
                                              ta.l_width)),
            ("tri9", ta.tri9, f32, (ta.tri9.shape[0], 9)),
            ("origin", ta.origin, f32, (3,))):
        _check(name, x, dev, dtype, shape)
    if tuple(br.dims) != (nx, ny, nz) or nx * ny * nz >= 2 ** 31:
        raise ValueError(f"tri_march_cuda: brick accel dims {br.dims} do "
                         f"not fit the tri grid {ta.dims}")
    if br.coarse.numel() * 32 < bx * by * bz or nb < bx * by * bz:
        raise ValueError(f"tri_march_cuda: brick tables too small for "
                         f"{br.bdims}")
    l2 = None
    if use_two_level(br, two_level):
        l2 = br.l2
        _check("l2", l2, dev, i32, l2.shape)
        l2_words = l2.numel()
        n_sup = (-(-bx // 8)) * (-(-by // 8)) * (-(-bz // 8))
        if l2_words * 32 < n_sup or l2_words > SMEM_WORDS:
            raise ValueError(f"tri_march_cuda: l2 table of {l2_words} words "
                             f"does not fit {br.bdims} or shared memory")
    outs = (torch.empty((n,), dtype=f32, device=dev),
            torch.empty((n,), dtype=i32, device=dev),
            torch.empty((n,), dtype=f32, device=dev),
            torch.empty((n,), dtype=f32, device=dev),
            torch.zeros((1,), dtype=torch.int64, device=dev))
    if n == 0:
        return outs
    fn = _lib(lib)
    with torch.cuda.device(dev):
        lanes = launch_config(ta, lib, two_level)["lanes"]
        args = _launch_args(o, d, t_min, t_max, ta, l2, outs, lanes)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[x.data_ptr() if torch.is_tensor(x) else x for x in args],
                 stream)
    check(err, "tri_march_launch")
    trace.count("launches.tri_march")
    return outs
