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
`launches.staged_march` (utils/trace.py).  `staged_args` builds a
launch's argument block on any device, so the host build of the kernel
(tests/) runs the same blocks.
"""
from __future__ import annotations

import ctypes

import torch

from . import brick_fine
from ._build import F, I, P, config, fields, launch, need, need_rays, on_cuda
from .brick_fine import fine_walk_multi
from .grid_walk import coarse_walk, coarse_walk_init
from .mega_trace import STRIPES

__all__ = ["staged_march_plain", "staged_march_cuda", "staged_args",
           "use_two_level", "max_drain_laps", "launch_config",
           "StagedMarchArgs"]

BRICK = 8
# occupied bricks per ray that each drain lap of the staged walk finds
_DRAIN_K = 8
# shared memory for the superbrick and brick masks (staged_march's brick
# words and tri_march's row staging come on top): the 48 KB a block gets
# without opting in; the brick mask is read from global memory when both
# do not fit
SMEM_WORDS = 48 * 1024 // 4
# the deferral's counters: three ints, each on a 128-byte line of its own
_SCHED_WORDS = 3 * 32


class StagedMarchArgs(ctypes.Structure):
    """csrc/staged_march.cu's StagedMarchArgs."""
    SIZES = ("staged_march_sizes", 0)
    _fields_ = fields((P, "o d t_min t_max admit coarse"),
                      (I, "coarse_words"), (P, "l2"), (I, "l2_words"),
                      (P, "fine"),
                      (I, "nb fine_off n nx ny bx by bz"),
                      (F, "ogx ogy ogz vs half bwf scale"),
                      (I, "k_first k_drain max_groups smem_words"),
                      (P, "t_out lin_out unresolved next_ray"),
                      (I, "stripes"),
                      (P, "sched deferred deferred_group"))


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


def set_tables(a, what, accel, two_level, dev):
    """Set argument block a's brick accel, its tables contiguous on
    `dev`: the brick and fine tables, the l2 table where the walk takes
    two levels (checked to fit), the brick grid and its constants.  a.nb:
    the fine table's bricks."""
    i32 = torch.int32
    a.coarse = need(what, "coarse", accel.coarse, dev, i32)
    a.coarse_words = accel.coarse.numel()
    a.fine = need(what, "fine", accel.fine, dev, i32, (16, a.nb))
    if use_two_level(accel, two_level):
        a.l2 = need(what, "l2", accel.l2, dev, i32)
        a.l2_words = accel.l2.numel()
        bx, by, bz = accel.bdims
        n_sup = (-(-bx // 8)) * (-(-by // 8)) * (-(-bz // 8))
        if a.l2_words * 32 < n_sup or a.l2_words > SMEM_WORDS:
            raise ValueError(f"{what}: l2 table of {a.l2_words} words does "
                             f"not fit {accel.bdims} or shared memory")
    brick_fine.set_grid(a, accel.origin_key, accel.voxel_size, accel.bdims)


def table_words(accel, two_level):
    """The words of tables a block holds in shared memory: the l2 mask
    (two levels) and the brick mask where both fit in SMEM_WORDS."""
    l2_words = accel.l2.numel() if use_two_level(accel, two_level) else 0
    coarse = accel.coarse.numel()
    return l2_words + (coarse if l2_words + coarse <= SMEM_WORDS else 0)


def staged_args(o, d, accel, tmn, tmx, admit, k_hits, two_level,
                lanes=None):
    """(the argument block, (t, lin, unresolved)) of the kernel's launch,
    arguments as staged_march_plain's, every tensor contiguous on o's
    device; the outputs allocated there (unresolved a zeroed 0-d int64),
    with the zeroed stripe counters and, where the rays outnumber `lanes`
    (the lanes the launch holds at once; None: as many as the rays) and
    there is no admit mask, the deferral's zeroed counters and
    deferred-ray slots, all on the block (`keep`)."""
    dev, n = o.device, o.shape[0]
    f32, i32, what = torch.float32, torch.int32, "staged_march_cuda"
    bx, by, bz = accel.bdims
    nb = accel.fine.shape[1]
    a = StagedMarchArgs(n=n, nb=nb, fine_off=int(accel.fine_off),
                        k_first=int(k_hits), k_drain=_DRAIN_K,
                        max_groups=max_drain_laps(accel.bdims) + 1,
                        smem_words=SMEM_WORDS, stripes=STRIPES)
    need_rays(a, what, o, d, tmn, tmx)
    if admit is not None:
        a.admit = need(what, "admit", admit, dev, torch.bool, (n,))
    set_tables(a, what, accel, two_level, dev)
    if bx * by * bz >= 2 ** 31 or nb * 16 >= 2 ** 31 or n >= 2 ** 30:
        raise ValueError(f"{what}: brick grid {accel.bdims}, fine window "
                         f"of {nb} bricks or {n} rays exceed int32 indexing")
    if a.coarse_words * 32 < bx * by * bz or a.fine_off < 0:
        raise ValueError(f"{what}: brick tables do not fit {accel.bdims}")
    if not 1 <= k_hits <= 64:
        raise ValueError(f"{what}: k_hits {k_hits} outside 1..64")
    a.nx, a.ny, _ = accel.dims
    outs = (torch.empty((n,), dtype=f32, device=dev),
            torch.empty((n,), dtype=i32, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))
    a.t_out, a.lin_out, a.unresolved = (x.data_ptr() for x in outs)
    # the zeroed words in one buffer: stripe counters, then the deferral's
    # counters and the deferred rays' groups
    slots = admit is None and n > (n if lanes is None else lanes)
    stripes = STRIPES * 32
    zeroed = torch.zeros((stripes + (_SCHED_WORDS + n if slots else 0),),
                         dtype=i32, device=dev)
    a.keep = {"next_ray": zeroed[:stripes]}
    if slots:
        a.keep.update(sched=zeroed[stripes:stripes + _SCHED_WORDS],
                      deferred=torch.empty((n, 4), dtype=i32, device=dev),
                      deferred_group=zeroed[stripes + _SCHED_WORDS:])
    for k, x in a.keep.items():
        setattr(a, k, x.data_ptr())
    return a, outs


def launch_config(accel, two_level=None, lib=None):
    """How the kernel launches on `accel` on the tables' device:
    {"group_budget": the groups after which a ray is deferred (0: never),
    "threads": a block's, "smem_bytes": its dynamic shared memory (the l2
    and brick masks, then the lanes' slots for K4's brick words),
    "blocks_per_sm": the blocks a multiprocessor holds, "lanes": the rays
    the card holds at once}, asked of the library once for each device
    and table size.  two_level: as staged_march_cuda's; lib: another build
    of csrc/staged_march.cu (default the kernel library)."""
    return dict(config("staged_march", ("group_budget", "threads",
                                         "smem_bytes", "blocks_per_sm"),
                       table_words(accel, two_level),
                       accel.coarse.device.index, lib))


def staged_march_cuda(o, d, accel, tmn, tmx, admit, k_hits, two_level):
    """Launch the kernel; arguments and (t, lin) as staged_march_plain,
    every tensor contiguous on one CUDA device.  unresolved comes back as
    a 0-d int64 tensor on the device (reading it waits for the kernel);
    nothing here waits for the device."""
    on_cuda("staged_march_cuda", o.device)
    lanes = launch_config(accel, two_level)["lanes"] if o.shape[0] else None
    a, outs = staged_args(o, d, accel, tmn, tmx, admit, k_hits, two_level,
                          lanes)
    if a.n:
        launch("staged_march", a, o.device)
    return outs
