"""staged_march: the staged trace in one launch (csrc/staged_march.cu).

Replaces the lap loop that drives K3 and K4 (the Pallas kernels
voxelray_tpu/ops/pallas/grid_walk.py:496/:569 and brick_fine.py:296,
with the lap glue of voxelray_tpu/ops/traverse_fast.py:365,
`_trace_fast_impl`) by one launch per trace: one lane holds one ray
through K3's fused init, every group of K3 brick steps and K4 over the
group's bricks, until the ray has its first accepted cell or retires.

`staged_march_plain` is that lap loop over tensors: round 1 walks every
ray (or only the admitted ones) with K3's fused init, K4 resolves each
ray's k_hits candidate bricks in walk order, and rays with no accepted
cell that can go on are walked again, _DRAIN_K bricks at a time, until
none is left.  It launches K3 and K4 on CUDA tensors (the reference the
kernel is held to on the card, and its "before") and runs their plain
versions on CPU tensors.

ops/traverse_fast.trace_grid_fast(mega=False) dispatches: CUDA tensors
launch the kernel (`staged_march_cuda`), CPU tensors run
`staged_march_plain`, whose (t, lin, unresolved) the kernel gives bit for
bit; any other device raises.  Each launch adds 1 to the counter
`launches.staged_march` (utils/trace.py).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import brick_fine
from ...utils import trace
from ._build import check, load_library
from .brick_fine import fine_walk_multi
from .grid_walk import coarse_walk, coarse_walk_init
from .mega_trace import STRIPES

__all__ = ["staged_march_plain", "staged_march_cuda", "use_two_level",
           "max_drain_laps", "launch_config"]

BRICK = 8
# occupied bricks per ray that each drain lap of the staged walk finds
_DRAIN_K = 8
# shared memory for the superbrick and brick masks: the 48 KB a block
# gets without opting in; the brick mask is read from global memory when
# both do not fit
SMEM_WORDS = 48 * 1024 // 4
# the deferral's counters: three ints, each on a 128-byte line of its own
_SCHED_WORDS = 3 * 32


def use_two_level(accel, two_level):
    """The staged walk's superbrick skip: two_level, or with None the
    skip when `coarse` has more than 4 rows."""
    return accel.coarse.shape[0] > 4 if two_level is None else bool(two_level)


def max_drain_laps(bdims):
    """Drain laps of one staged trace at most: each consumes _DRAIN_K
    occupied bricks of a walk of at most bx+by+bz+3 steps."""
    bx, by, bz = bdims
    return (bx + by + bz + 3 + _DRAIN_K - 1) // _DRAIN_K + 1


def staged_march_plain(o, d, accel, tmn, tmx, admit, k_hits, two_level):
    """The staged trace over (N, 3) float32 rays o, d with (N,) float32
    bounds tmn, tmx; admit: (N,) bool or None (every ray).

    Round 1 walks every ray, or with an admit mask only the admitted
    ones, seeded in K3 from the grid-bbox clip and t_min (the start
    fast-forwards to o + d * t_min: the cells before it have slab
    t0 < t_min, which K4's accept rejects anyway); K4 resolves each
    ray's k_hits candidate bricks in walk order.  Rays with no accepted
    cell that can go on are walked again, _DRAIN_K bricks at a time,
    until none is left; each such lap consumes _DRAIN_K occupied bricks
    or retires the ray, so the laps are bounded by the walk's step bound.
    Active rays are kept as an index set (torch.nonzero), so every lap
    costs one host sync.  Returns (t, lin, unresolved): t = +inf, lin =
    -1 on a miss; unresolved (an int) counts rays still active at that
    bound and is 0 by construction.
    """
    n, dev = o.shape[0], o.device
    l2 = accel.l2 if use_two_level(accel, two_level) else None
    wkw = dict(bdims=accel.bdims, origin_key=accel.origin_key,
               brick_world=float(accel.voxel_size * BRICK))
    fkw = dict(dims=accel.dims, bdims=accel.bdims,
               origin_key=accel.origin_key, voxel_size=accel.voxel_size,
               fine_off=accel.fine_off)
    best_t = torch.full((n,), float("inf"), device=dev)
    best_lin = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if admit is None:
        idx = torch.arange(n, device=dev)
        hits, cell, cont = coarse_walk_init(o, d, tmn, tmx, accel.coarse,
                                            l2, k_hits=k_hits, **wkw)
    else:
        idx = torch.nonzero(admit).squeeze(1)
        hits, cell, cont = coarse_walk_init(o[idx], d[idx], tmn[idx],
                                            tmx[idx], accel.coarse, l2,
                                            k_hits=k_hits, **wkw)
    max_laps = max_drain_laps(accel.bdims)
    for lap in range(max_laps + 1):
        t, lin = fine_walk_multi(o[idx], d[idx], hits, accel.fine, tmn[idx],
                                 tmx[idx], **fkw)
        got = torch.isfinite(t)
        best_t[idx[got]] = t[got]
        best_lin[idx[got]] = lin[got]
        keep = torch.nonzero(~got & (cont > 0)).squeeze(1)
        idx, cell = idx[keep], cell[keep]
        if idx.numel() == 0 or lap == max_laps:
            break
        hits, cell, cont = coarse_walk(
            o[idx], d[idx], cell,
            torch.ones(idx.shape, dtype=torch.int32, device=dev), tmx[idx],
            accel.coarse, l2, k_hits=_DRAIN_K, **wkw)
    return best_t, best_lin, idx.numel()


def _launch_args(o, d, tmn, tmx, admit, accel, l2, k_hits, outs,
                 lanes=None):
    """staged_march_launch's arguments but the stream, in order, tensors as
    tensors (None for a null pointer): inputs, the accel's tables (l2
    None: single level), the grid constants, the lap loop's schedule, the
    outputs `outs` (t, lin, unresolved), then the zeroed stripe counters,
    and the deferral's zeroed counters and deferred-ray slots (allocated
    here, on o's device, the zeroed parts in one buffer with the stripe
    counters; None, no ray deferred, with an admit mask or where the rays
    do not outnumber `lanes`, the lanes the launch holds at once; None:
    as many as the rays)."""
    og, vs, half, bwf, scale = brick_fine._consts(
        accel.origin_key, accel.voxel_size, accel.bdims)
    n, dev = o.shape[0], o.device
    adm = None if admit is None else admit.view(torch.uint8)
    slots = admit is None and n > (n if lanes is None else lanes)
    stripes = STRIPES * 32
    zeroed = torch.zeros((stripes + (_SCHED_WORDS + n if slots else 0),),
                         dtype=torch.int32, device=dev)
    return (o, d, tmn, tmx, adm, accel.coarse, accel.coarse.numel(), l2,
            0 if l2 is None else l2.numel(), accel.fine, accel.fine.shape[1],
            int(accel.fine_off), n, accel.dims[0], accel.dims[1],
            *accel.bdims, *map(float, og), float(vs), float(half),
            float(bwf), float(scale), int(k_hits), _DRAIN_K,
            max_drain_laps(accel.bdims) + 1, SMEM_WORDS, *outs,
            zeroed[:stripes], STRIPES,
            zeroed[stripes:stripes + _SCHED_WORDS] if slots else None,
            torch.empty((n, 4), dtype=torch.int32, device=dev)
            if slots else None,
            zeroed[stripes + _SCHED_WORDS:] if slots else None)


def _lib(lib=None):
    """staged_march_launch of the kernel library (or of `lib`, a build of
    csrc/staged_march.cu alone) with its argument types."""
    fn = (lib or load_library()).staged_march_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([vp] * 6 + [ci, vp, ci, vp] + [ci] * 8 + [cf] * 7
                   + [ci] * 4 + [vp] * 4 + [ci] + [vp] * 4)
    fn.restype = ci
    return fn


def launch_config(accel, lib=None, two_level=None):
    """How the kernel launches on `accel` with the current device:
    {"group_budget": the groups after which a ray is deferred (0: never),
    "threads": a block's, "smem_bytes": its dynamic shared memory (the l2
    and brick masks, then the lanes' slots for K4's brick words),
    "blocks_per_sm": the blocks a multiprocessor holds, "lanes": the rays
    the card holds at once}.  lib: another build of csrc/staged_march.cu
    (default the kernel library); two_level: as staged_march_cuda's."""
    l2_words = accel.l2.numel() if use_two_level(accel, two_level) else 0
    coarse = accel.coarse.numel()
    table_words = l2_words + (coarse if l2_words + coarse <= SMEM_WORDS
                              else 0)
    fn = (lib or load_library()).staged_march_config
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    check(fn(table_words, out), "staged_march_config")
    cfg = dict(zip(("group_budget", "threads", "smem_bytes",
                    "blocks_per_sm"), out))
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    cfg["lanes"] = cfg["threads"] * cfg["blocks_per_sm"] * sms
    return cfg


def _check(name, x, dev, dtype, shape):
    if not x.is_cuda or x.device != dev:
        raise ValueError(f"staged_march_cuda: {name} not on {dev}")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"staged_march_cuda: {name} must be {dtype} "
                         f"{tuple(shape)}, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"staged_march_cuda: {name} not contiguous")


def staged_march_cuda(o, d, accel, tmn, tmx, admit, k_hits, two_level,
                      lib=None):
    """Launch the kernel; arguments and (t, lin) as staged_march_plain,
    every tensor contiguous on one CUDA device.  unresolved comes back as
    a 0-d int64 tensor on the device (reading it waits for the kernel);
    nothing here waits for the device.  lib: another build of
    csrc/staged_march.cu (default the kernel library)."""
    dev = o.device
    n = o.shape[0]
    f32, i32 = torch.float32, torch.int32
    bx, by, bz = accel.bdims
    nb = accel.fine.shape[1]
    for name, x, dtype, shape in (
            ("o", o, f32, (n, 3)), ("d", d, f32, (n, 3)),
            ("t_min", tmn, f32, (n,)), ("t_max", tmx, f32, (n,)),
            ("coarse", accel.coarse, i32, accel.coarse.shape),
            ("fine", accel.fine, i32, (16, nb))):
        _check(name, x, dev, dtype, shape)
    if admit is not None:
        _check("admit", admit, dev, torch.bool, (n,))
    if bx * by * bz >= 2 ** 31 or nb * 16 >= 2 ** 31 or n >= 2 ** 30:
        raise ValueError(f"staged_march_cuda: brick grid {accel.bdims}, "
                         f"fine window of {nb} bricks or {n} rays exceed "
                         "int32 indexing")
    if accel.coarse.numel() * 32 < bx * by * bz or accel.fine_off < 0:
        raise ValueError(f"staged_march_cuda: brick tables do not fit "
                         f"{accel.bdims}")
    if not 1 <= k_hits <= 64:
        raise ValueError(f"staged_march_cuda: k_hits {k_hits} outside 1..64")
    l2 = None
    if use_two_level(accel, two_level):
        l2 = accel.l2
        _check("l2", l2, dev, i32, l2.shape)
        n_sup = (-(-bx // 8)) * (-(-by // 8)) * (-(-bz // 8))
        if l2.numel() * 32 < n_sup or l2.numel() > SMEM_WORDS:
            raise ValueError(f"staged_march_cuda: l2 table of {l2.numel()} "
                             f"words does not fit {accel.bdims} or shared "
                             "memory")
    outs = (torch.empty((n,), dtype=f32, device=dev),
            torch.empty((n,), dtype=i32, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))
    if n == 0:
        return outs
    fn = _lib(lib)
    with torch.cuda.device(dev):
        lanes = launch_config(accel, lib, two_level)["lanes"]
        args = _launch_args(o, d, tmn, tmx, admit, accel, l2, k_hits, outs,
                            lanes)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[x.data_ptr() if torch.is_tensor(x) else x for x in args],
                 stream)
    check(err, "staged_march_launch")
    trace.count("launches.staged_march")
    return outs

