"""K3: the brick-level walk of the staged trace (csrc/grid_walk.cu).

Replaces the Pallas kernels of voxelray_tpu/ops/pallas/grid_walk.py:
`coarse_walk` resumes each ray's brick DDA from a given (cell, active)
state, `coarse_walk_init` seeds it from the grid-bbox clip and a per-ray
t_min (`_fused_init`).  Both return the next k_hits occupied bricks per
ray ((k_hits, N) int32 brick lin, -1 = none) and the walk state after them:
the cell (N, 3) int32 and `cont` (N,) int32, 1 where the ray can go on.
Passing the superbrick bitmask `l2` selects the two-level walk, whose
brick sequence is the single-level one's.

CUDA tensors launch the kernel; CPU tensors run the plain PyTorch version
(`walk_plain`), which evaluates the kernel's float32 expressions
vectorized over rays, one step at a time, with the same per-ray step bound
bx+by+bz+3.  Any other device raises.  Each launch adds 1 to the counter
`launches.grid_walk` (utils/trace.py).  `walk_args` builds a launch's
argument block on any device, so the host build of the kernel (tests/)
runs the same blocks.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..geometry import div_scalar, floor_cell
from ._build import F, I, P, fields, launch, need, need_rays, on_cuda

__all__ = ["coarse_walk", "coarse_walk_init", "walk_plain", "walk_cuda",
           "walk_args", "GridWalkArgs"]

_INF = float("inf")


class GridWalkArgs(ctypes.Structure):
    """csrc/grid_walk.cu's GridWalkArgs."""
    SIZES = ("grid_walk_sizes", 0)
    _fields_ = fields((P, "o d t_min t_max cell_in active_in coarse l2"),
                      (I, "l2_words n bx by bz"), (F, "ogx ogy ogz bwf"),
                      (I, "k_hits"), (P, "hits_out cell_out cont_out"))


def _bit(table, lin):
    """Bit `lin` of a flat int32 word table (lanes out of range read the
    clamped word; callers mask them)."""
    word = table[torch.clamp(lin >> 5, 0, table.numel() - 1).long()]
    return ((word >> (lin & 31)) & 1) != 0


def _consts(origin_key, brick_world):
    """float32 (origin, brick width): the kernel's float arguments."""
    return np.asarray(origin_key, np.float32), np.float32(brick_world)


def walk_plain(o, d, t_min, t_max, cell, active, coarse, l2, *, bdims,
               origin_key, brick_world, k_hits, count_steps=False,
               per_hit=False):
    """Plain version of the walk.  o, d: (N, 3) float32; t_max (N,); the
    entry state is (cell (N, 3) int32, active (N,)) or, with cell None,
    the fused init from t_min (N,).  coarse, l2: int32 word tables (l2
    None: single level).  Returns (hits (k, N), cell (N, 3), cont (N,)),
    and with count_steps=True also the number of loop iterations summed
    over the rays: the kernel's per-thread steps on the same inputs.
    per_hit=True counts per ray instead: an int64 (k, N) tensor whose row
    s holds each ray's iterations up to and including the one that found
    its hit s (all of its iterations where it found none)."""
    bx, by, bz = bdims
    sbx, sby = -(-bx // 8), -(-by // 8)
    og32, bw32 = _consts(origin_key, brick_world)
    og = [float(x) for x in og32]
    bw = float(bw32)
    n, dev = o.shape[0], o.device
    i32 = torch.int32
    oa, da = list(o.unbind(1)), list(d.unbind(1))
    inv = [1.0 / x for x in da]
    sgn = [torch.where(x >= 0, 1, -1).to(i32) for x in da]
    fwd = [(s > 0).to(i32) for s in sgn]
    inf = torch.full((n,), _INF, device=dev)
    hi_b = (bx, by, bz)
    if cell is None:
        gm = [float(og32[a] + np.float32(hi_b[a]) * bw32) for a in range(3)]
        tb = [inv[a] * (og[a] - oa[a]) for a in range(3)]
        tt = [inv[a] * (gm[a] - oa[a]) for a in range(3)]
        tn = [torch.minimum(tb[a], tt[a]) for a in range(3)]
        tf = [torch.maximum(tb[a], tt[a]) for a in range(3)]
        t_enter = torch.maximum(torch.maximum(tn[0], tn[1]), tn[2])
        t_exit = torch.minimum(torch.minimum(tf[0], tf[1]), tf[2])
        lo = torch.maximum(torch.clamp(t_enter, min=0.0), t_min)
        t_start = lo + 1e-7
        act = ((t_exit > torch.clamp(t_enter, min=0.0)) & (t_start <= t_max)
               & (t_start <= t_exit + 1e-7))
        c = [torch.clamp(floor_cell(div_scalar(
            oa[a] + da[a] * t_start - og[a], bw)), 0, hi_b[a] - 1)
            for a in range(3)]
    else:
        c = [x.to(i32) for x in cell.unbind(1)]
        act = active.to(torch.bool).clone()
    coarse = coarse.reshape(-1)
    l2 = None if l2 is None else l2.reshape(-1)
    hits = torch.full((k_hits, n), -1, dtype=i32, device=dev)
    nhit = torch.zeros((n,), dtype=i32, device=dev)

    def in_grid(c):
        return ((c[0] >= 0) & (c[0] < bx) & (c[1] >= 0) & (c[1] < by)
                & (c[2] >= 0) & (c[2] < bz))

    steps = torch.zeros((), dtype=torch.int64, device=dev)
    if per_hit:
        ray_steps = torch.zeros((n,), dtype=torch.int64, device=dev)
        hit_steps = torch.zeros((k_hits, n), dtype=torch.int64, device=dev)
    for _ in range(bx + by + bz + 3):
        if not bool(act.any()):
            break
        if count_steps:
            steps += act.sum()
        if per_hit:
            ray_steps += act
        if l2 is not None:
            sc = [x >> 3 for x in c]
            skip = act & ~_bit(l2, sc[0] + sbx * (sc[1] + sby * sc[2]))
            ts = [torch.where(da[a] == 0.0, inf, (og[a] + (
                (sc[a] + fwd[a]) * 8).to(torch.float32) * bw - oa[a])
                * inv[a]) for a in range(3)]
            t_ex = torch.minimum(ts[0], torch.minimum(ts[1], ts[2]))
            for a in range(3):
                lb = floor_cell(div_scalar(oa[a] + da[a] * t_ex - og[a], bw))
                land = torch.minimum(torch.maximum(lb - sgn[a], sc[a] * 8),
                                     sc[a] * 8 + 7)
                land = torch.where(sgn[a] > 0, torch.maximum(land, c[a]),
                                   torch.minimum(land, c[a]))
                c[a] = torch.where(skip, land, c[a])
        lin = c[0] + bx * (c[1] + by * c[2])
        # a two-level landing can lie outside the grid (in a superbrick
        # that sticks out of it): such a cell is empty
        hit_now = act & in_grid(c) & _bit(coarse, lin)
        for s in range(k_hits):
            hits[s] = torch.where(hit_now & (nhit == s), lin, hits[s])
            if per_hit:
                hit_steps[s] = torch.where(hit_now & (nhit == s), ray_steps,
                                           hit_steps[s])
        nhit = nhit + hit_now.to(i32)
        t = [torch.where(da[a] == 0.0, inf, (og[a] + (c[a] + fwd[a]).to(
            torch.float32) * bw - oa[a]) * inv[a]) for a in range(3)]
        tmn = torch.minimum(t[0], torch.minimum(t[1], t[2]))
        stx = act & (t[0] == tmn)
        sty = act & ~stx & (t[1] == tmn)
        stz = act & ~(stx | sty)
        for a, st in enumerate((stx, sty, stz)):
            c[a] = c[a] + torch.where(st, sgn[a], 0)
        act = act & (nhit < k_hits) & in_grid(c) & (tmn <= t_max)
    cont = in_grid(c) & (act | (nhit >= k_hits))
    out = (hits, torch.stack(c, dim=1), cont.to(i32))
    if per_hit:
        return out + (torch.where(hits >= 0, hit_steps, ray_steps),)
    return out + (int(steps),) if count_steps else out


def walk_args(o, d, t_min, t_max, cell, active, coarse, l2, *, bdims,
              origin_key, brick_world, k_hits):
    """(the argument block, (hits, cell, cont)) of K3's launch, the
    outputs allocated on o's device, unwritten; arguments as walk_cuda's,
    on any one device."""
    dev, n = o.device, o.shape[0]
    f32, i32, what = torch.float32, torch.int32, "walk_cuda"
    a = GridWalkArgs(n=n, k_hits=k_hits)
    need_rays(a, what, o, d, t_min if cell is None else None, t_max)
    if cell is not None:
        a.cell_in = need(what, "cell", cell, dev, i32, (n, 3))
        a.active_in = need(what, "active", active, dev, i32, (n,))
    bx, by, bz = bdims
    a.bx, a.by, a.bz = bx, by, bz
    if bx * by * bz >= 2 ** 31:
        raise ValueError(f"brick grid {bdims} exceeds int32 indexing")
    a.coarse = need(what, "coarse", coarse, dev, i32)
    if coarse.numel() * 32 < bx * by * bz:
        raise ValueError(f"{what}: coarse table too small for {bdims}")
    if l2 is not None:
        a.l2 = need(what, "l2", l2, dev, i32)
        a.l2_words = l2.numel()
        n_sup = (-(-bx // 8)) * (-(-by // 8)) * (-(-bz // 8))
        if a.l2_words * 32 < n_sup or a.l2_words * 4 > 48 * 1024:
            raise ValueError(f"{what}: l2 table of {a.l2_words} words does "
                             f"not fit {bdims} or shared memory")
    if not 1 <= k_hits <= 64:
        raise ValueError(f"{what}: k_hits {k_hits} outside 1..64")
    og32, bw32 = _consts(origin_key, brick_world)
    a.ogx, a.ogy, a.ogz = (float(x) for x in og32)
    a.bwf = float(bw32)
    outs = (torch.empty((k_hits, n), dtype=i32, device=dev),
            torch.empty((n, 3), dtype=i32, device=dev),
            torch.empty((n,), dtype=i32, device=dev))
    a.hits_out, a.cell_out, a.cont_out = (x.data_ptr() for x in outs)
    return a, outs


def walk_cuda(o, d, t_min, t_max, cell, active, coarse, l2, *, bdims,
              origin_key, brick_world, k_hits):
    """Launch K3; arguments as walk_plain, every tensor contiguous on one
    CUDA device (t_min float32 (N,) with cell None; cell int32 (N, 3) and
    active int32 (N,) otherwise)."""
    on_cuda("walk_cuda", o.device)
    a, outs = walk_args(o, d, t_min, t_max, cell, active, coarse, l2,
                        bdims=bdims, origin_key=origin_key,
                        brick_world=brick_world, k_hits=k_hits)
    if a.n:
        launch("grid_walk", a, o.device)
    return outs


def _walk(o, d, t_min, t_max, cell, active, coarse, l2, **kw):
    if o.is_cuda:
        return walk_cuda(o, d, t_min, t_max, cell, active, coarse, l2, **kw)
    if o.device.type == "cpu":
        return walk_plain(o, d, t_min, t_max, cell, active, coarse, l2, **kw)
    raise ValueError(f"coarse_walk: unsupported device {o.device}")


def coarse_walk(o, d, cell, active, t_max, coarse, l2=None, *, bdims,
                origin_key, brick_world, k_hits=1):
    """Walk each ray from (cell, active) to its next k_hits occupied bricks.

    o, d: (N, 3) float32; cell (N, 3) int; active (N,) bool or int;
    t_max (N,) float32; coarse/l2: the BrickAccel's int32 bitmasks (l2
    None = single-level walk).  Returns (hits (k_hits, N) int32,
    cell (N, 3) int32, cont (N,) int32).
    """
    return _walk(o.contiguous(), d.contiguous(), None, t_max.contiguous(),
                 cell.to(torch.int32).contiguous(),
                 active.to(torch.int32).contiguous(), coarse.contiguous(),
                 None if l2 is None else l2.contiguous(), bdims=bdims,
                 origin_key=origin_key, brick_world=brick_world,
                 k_hits=k_hits)


def coarse_walk_init(o, d, t_min, t_max, coarse, l2=None, *, bdims,
                     origin_key, brick_world, k_hits=1):
    """coarse_walk seeded in the kernel from the grid-bbox clip and the
    per-ray t_min (N,) float32; same outputs."""
    return _walk(o.contiguous(), d.contiguous(), t_min.contiguous(),
                 t_max.contiguous(), None, None, coarse.contiguous(),
                 None if l2 is None else l2.contiguous(), bdims=bdims,
                 origin_key=origin_key, brick_world=brick_world,
                 k_hits=k_hits)
