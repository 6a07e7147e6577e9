"""K4: the per-voxel walk through candidate bricks (csrc/brick_fine.cu).

Replaces the Pallas kernel of voxelray_tpu/ops/pallas/brick_fine.py
(`_make_kernel`, launched by `fine_walk_multi`).  For each ray and each of
its K candidate bricks in slot order ((K, N) int32 brick lin, -1 = none),
a DDA over the cells the ray crosses inside the brick with the
reference's slab test and accept rule; the first accepted cell gives
(t, cell lin), a ray with none gets (+inf, -1).

Unlike the TPU kernel, which takes the bricks' occupancy words gathered
beforehand into a (K, 16, N) array, this one reads them from the accel's
fine table (16, NB) by brick id: the kernel and the plain version see the
same words, and the gathered copy is never written.  The table may be a
window of the bricks from id `fine_off` on (a Z-slab accel,
ops/traverse_fast.build_accel_slab): brick b is its column b - fine_off,
a candidate brick outside the window counts as none (-1), and a cell
there reads as empty.

CUDA tensors launch the kernel; CPU tensors run the plain PyTorch version
(`fine_plain`), the same float32 expressions vectorized over rays.  Any
other device raises.  Each launch adds 1 to the counter
`launches.brick_fine` (utils/trace.py).  `fine_args` builds a launch's
argument block on any device, so the host build of the kernel (tests/)
runs the same blocks.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..geometry import div_scalar, floor_cell
from ._build import F, I, P, fields, launch, need, need_rays, on_cuda

__all__ = ["fine_walk_multi", "fine_walk", "fine_plain", "fine_cuda",
           "fine_args", "BrickFineArgs"]

BRICK = 8
STEPS = 3 * BRICK + 1


class BrickFineArgs(ctypes.Structure):
    """csrc/brick_fine.cu's BrickFineArgs."""
    SIZES = ("brick_fine_sizes", 0)
    _fields_ = fields((P, "o d bricks"), (I, "k_slots"), (P, "fine"),
                      (I, "nb fine_off"), (P, "t_min t_max"),
                      (I, "n nx ny bx by bz"),
                      (F, "ogx ogy ogz vs half bwf scale"),
                      (P, "t_out lin_out"))


def _consts(origin_key, voxel_size, bdims):
    """float32 (origin, vs, half, brick width, scale): scale is the
    largest |coordinate| of the brick grid's corners, as K2 computes it."""
    og = np.asarray(origin_key, np.float32)
    vs = np.float32(voxel_size)
    gmax = og + np.asarray(bdims, np.float32) * np.float32(voxel_size * BRICK)
    scale = np.float32(max(np.abs(og).max(), np.abs(gmax).max()))
    return og, vs, np.float32(0.5) * vs, np.float32(BRICK) * vs, scale


def set_grid(a, origin_key, voxel_size, bdims):
    """Set argument block a's brick grid bx, by, bz and its float32
    constants (_consts)."""
    a.bx, a.by, a.bz = bdims
    og, vs, half, bwf, scale = _consts(origin_key, voxel_size, bdims)
    a.ogx, a.ogy, a.ogz = (float(x) for x in og)
    a.vs, a.half, a.bwf, a.scale = map(float, (vs, half, bwf, scale))


def fine_plain(o, d, bricks, fine, t_min, t_max, *, dims, bdims,
               origin_key, voxel_size, fine_off=0, count_steps=False,
               per_hit=False):
    """Plain version.  o, d: (N, 3) float32; bricks (K, N) int32; fine
    (16, NB) int32 words of the bricks from id fine_off on; t_min, t_max
    (N,) float32.  Returns (t, lin),
    and with count_steps=True also each ray's cell steps over its slots,
    (N,) int64: the kernel's per-thread steps on the same inputs; with
    per_hit=True too, last, the (N,) int64 slot at which each ray's hit
    was decided (K where it was not)."""
    nx, ny, _ = dims
    bx, by, bz = bdims
    og32, vs32, half32, bwf32, scale32 = _consts(origin_key, voxel_size,
                                                 bdims)
    og = [float(x) for x in og32]
    vs, half, bwf = float(vs32), float(half32), float(bwf32)
    n, dev = o.shape[0], o.device
    i32, f32 = torch.int32, torch.float32
    oa, da = list(o.unbind(1)), list(d.unbind(1))
    inv = [1.0 / x for x in da]
    ia = [x.abs() for x in inv]
    sgn = [torch.where(x >= 0, 1, -1).to(i32) for x in da]
    fwd = [(s > 0).to(i32) for s in sgn]
    inf = torch.full((n,), float("inf"), device=dev)
    # 16 ulps of the coordinate scale: the near-tie window (mega_trace.cu)
    tie_eps = torch.maximum(torch.maximum(torch.maximum(
        oa[0].abs(), oa[1].abs()), oa[2].abs()),
        torch.tensor(float(scale32), device=dev)) * 2.0 ** -20
    best_t = inf.clone()
    best_lin = torch.full((n,), -1, dtype=i32, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    nb, off = fine.shape[1], int(fine_off)
    flat = fine.reshape(-1)

    def cell_slab(g):
        """(t0, t1) of cells g = [gx, gy, gz]: the kernel's slab test."""
        t0 = t1 = None
        for a in range(3):
            cc = og[a] + (g[a].to(f32) + 0.5) * vs
            tb = inv[a] * ((cc - half) - oa[a])
            tt = inv[a] * ((cc + half) - oa[a])
            if a == 0:
                t0, t1 = torch.minimum(tb, tt), torch.maximum(tb, tt)
            else:
                t0 = torch.maximum(t0, torch.minimum(tb, tt))
                t1 = torch.minimum(t1, torch.maximum(tb, tt))
        return t0, t1

    def accepts(t0, t1):
        return ((t1 > torch.clamp(t0, min=0.0)) & (t0 > 0.0)
                & (t0 >= t_min) & (t0 <= t_max))

    def occupied(g):
        """Occupancy of cells g anywhere in the grid (0 outside it and
        outside the table's window)."""
        b = [x >> 3 for x in g]
        col = b[0] + bx * (b[1] + by * b[2]) - off
        inside = ((g[0] >= 0) & (g[1] >= 0) & (g[2] >= 0) & (b[0] < bx)
                  & (b[1] < by) & (b[2] < bz) & (col >= 0) & (col < nb))
        if nb == 0:
            return inside
        ll = (g[0] & 7) + BRICK * ((g[1] & 7) + BRICK * (g[2] & 7))
        idx = torch.where(inside, (ll >> 5) * nb + col, 0).long()
        return inside & (((flat[idx] >> (ll & 31)) & 1) != 0)

    def probe(mask, g):
        """probe_cell: a nearer accepted occupied cell g becomes the hit."""
        nonlocal best_t, best_lin
        t0, t1 = cell_slab(g)
        take = mask & occupied(g) & accepts(t0, t1) & (t0 < best_t)
        best_t = torch.where(take, t0, best_t)
        best_lin = torch.where(take, g[0] + nx * (g[1] + ny * g[2]),
                               best_lin)

    steps = torch.zeros((n,), dtype=torch.int64, device=dev)
    decided = torch.full((n,), bricks.shape[0], dtype=torch.int64,
                         device=dev)
    for s in range(bricks.shape[0]):
        bid = bricks[s].to(i32)
        act = (bid >= off) & (bid < off + nb) & ~done
        if not bool(act.any()):
            continue
        b = torch.clamp(bid, off, off + nb - 1)
        bc = [b % bx, (b // bx) % by, b // (bx * by)]
        bmin = [og[a] + (bc[a] * BRICK).to(f32) * vs for a in range(3)]
        ent = [torch.where(da[a] == 0.0, -inf, torch.minimum(
            (bmin[a] - oa[a]) * inv[a], (bmin[a] + bwf - oa[a]) * inv[a]))
            for a in range(3)]
        t_enter = torch.maximum(torch.maximum(ent[0], ent[1]), ent[2])
        t_start = torch.clamp(t_enter, min=0.0) + 1e-7
        loc = [torch.clamp(floor_cell(div_scalar(
            oa[a] + da[a] * t_start - bmin[a], vs)), 0, BRICK - 1)
            for a in range(3)]
        # the cell behind an entry face crossed within the tie window
        t_in = torch.clamp(t_enter, min=0.0)
        ie = torch.where(t_enter == ent[0], ia[0],
                         torch.where(t_enter == ent[1], ia[1], ia[2]))
        for k in range(3):
            face = (bmin[k] + (loc[k] + 1 - fwd[k]).to(f32) * vs
                    - oa[k]) * inv[k]
            near = (da[k] != 0.0) & ((face - t_in).abs()
                                     <= tie_eps * (ia[k] + ie))
            g = [bc[a] * BRICK + loc[a] - (sgn[a] if a == k else 0)
                 for a in range(3)]
            probe(act & near, g)
        words = fine[:, (b - off).long()]                   # (16, N)
        for _ in range(STEPS):
            if not bool(act.any()):
                break
            if count_steps:
                steps += act
            lin_local = loc[0] + BRICK * (loc[1] + BRICK * loc[2])
            # lanes that stepped out of the brick are inactive: clamp
            # their word index so the gather stays in range
            word = words.gather(0, torch.clamp(lin_local >> 5, 0, 15)
                                .long()[None])[0]
            occ = ((word >> (lin_local & 31)) & 1) != 0
            g = [bc[a] * BRICK + loc[a] for a in range(3)]
            t0, t1 = cell_slab(g)
            hit = act & occ & accepts(t0, t1)
            take = hit & (t0 < best_t)
            best_t = torch.where(take, t0, best_t)
            best_lin = torch.where(take, g[0] + nx * (g[1] + ny * g[2]),
                                   best_lin)
            done |= hit
            act = act & ~hit
            tn = [torch.where(da[a] == 0.0, inf, (bmin[a] + (
                loc[a] + fwd[a]).to(f32) * vs - oa[a]) * inv[a])
                for a in range(3)]
            tmn = torch.minimum(tn[0], torch.minimum(tn[1], tn[2]))
            # a probed candidate nearer than this cell's exit is the hit
            stop = act & (best_t <= tmn)
            done |= stop
            act = act & ~stop
            # pick_axis: the tie rule, unless another crossing is within
            # tie_eps; then follow the slab test and probe the others
            axis = torch.where(tn[0] == tmn, 0, torch.where(tn[1] == tmn,
                                                            1, 2))
            ia_ax = torch.where(axis == 0, ia[0],
                                torch.where(axis == 1, ia[1], ia[2]))
            near = [(axis == k) | (torch.isfinite(tn[k])
                                   & (tn[k] - tmn <= tie_eps * (ia[k]
                                                                + ia_ax)))
                    for k in range(3)]
            multi = (near[0].int() + near[1].int() + near[2].int()) > 1
            nbr = [[g[a] + (sgn[a] if a == k else 0) for a in range(3)]
                   for k in range(3)]
            passes = []
            for k in range(3):
                t0k, t1k = cell_slab(nbr[k])
                passes.append(t1k > t0k)
            pass_ax = torch.where(axis == 0, passes[0],
                                  torch.where(axis == 1, passes[1],
                                              passes[2]))
            new_axis = axis.clone()
            unset = multi & ~pass_ax
            for k in range(3):
                pick = unset & (axis != k) & near[k] & passes[k]
                new_axis = torch.where(pick, k, new_axis)
                unset = unset & ~pick
            axis = new_axis
            for k in range(3):
                probe(act & multi & near[k] & (axis != k), nbr[k])
            for k in range(3):
                loc[k] = loc[k] + torch.where(act & (axis == k), sgn[k], 0)
            inb = ((loc[0] >= 0) & (loc[0] < BRICK) & (loc[1] >= 0)
                   & (loc[1] < BRICK) & (loc[2] >= 0) & (loc[2] < BRICK))
            act = act & inb & (tmn <= t_max)
        decided = torch.where(done & (decided > s), s, decided)
    out = (best_t, best_lin) + ((steps,) if count_steps else ())
    return out + (decided,) if per_hit else out


def fine_args(o, d, bricks, fine, t_min, t_max, *, dims, bdims, origin_key,
              voxel_size, fine_off=0):
    """(the argument block, (t, lin)) of K4's launch, the outputs
    allocated on o's device, unwritten; arguments as fine_plain's,
    contiguous on any one device."""
    dev, n, k = o.device, o.shape[0], bricks.shape[0]
    f32, i32, what = torch.float32, torch.int32, "fine_cuda"
    a = BrickFineArgs(n=n, k_slots=k, nb=fine.shape[1], fine_off=fine_off)
    need_rays(a, what, o, d, t_min, t_max)
    a.bricks = need(what, "bricks", bricks, dev, i32, (k, n))
    a.fine = need(what, "fine", fine, dev, i32, (16, a.nb))
    if fine_off < 0 or a.nb * 16 >= 2 ** 31:
        raise ValueError(f"{what}: fine window of {a.nb} bricks from "
                         f"{fine_off} on does not fit int32 indexing")
    a.nx, a.ny, _ = dims
    set_grid(a, origin_key, voxel_size, bdims)
    outs = (torch.empty((n,), dtype=f32, device=dev),
            torch.empty((n,), dtype=i32, device=dev))
    a.t_out, a.lin_out = (x.data_ptr() for x in outs)
    return a, outs


def fine_cuda(o, d, bricks, fine, t_min, t_max, *, dims, bdims, origin_key,
              voxel_size, fine_off=0):
    """Launch K4; arguments as fine_plain, contiguous on one CUDA device."""
    on_cuda("fine_cuda", o.device)
    a, outs = fine_args(o, d, bricks, fine, t_min, t_max, dims=dims,
                        bdims=bdims, origin_key=origin_key,
                        voxel_size=voxel_size, fine_off=fine_off)
    if a.n:
        launch("brick_fine", a, o.device)
    return outs


def fine_walk_multi(o, d, bricks, fine, t_min, t_max, *, dims, bdims,
                    origin_key, voxel_size, fine_off=0):
    """First accepted cell across each ray's K candidate bricks, in slot
    order: (t (N,) float32, +inf on a miss; lin (N,) int32, -1).

    o, d: (N, 3) float32; bricks (K, N) int brick lins (-1 = none); fine:
    the BrickAccel's (16, NB) int32 words of the bricks from id fine_off
    on; t_min, t_max (N,) float32.
    """
    args = (o.contiguous(), d.contiguous(),
            bricks.to(torch.int32).contiguous(), fine.contiguous(),
            t_min.contiguous(), t_max.contiguous())
    kw = dict(dims=dims, bdims=bdims, origin_key=origin_key,
              voxel_size=voxel_size, fine_off=fine_off)
    if o.is_cuda:
        return fine_cuda(*args, **kw)
    if o.device.type == "cpu":
        return fine_plain(*args, **kw)
    raise ValueError(f"fine_walk_multi: unsupported device {o.device}")


def fine_walk(o, d, brick, fine, t_min, t_max, **kw):
    """Single-slot form: brick (N,) int brick lins (-1 = none)."""
    return fine_walk_multi(o, d, brick[None], fine, t_min, t_max, **kw)
