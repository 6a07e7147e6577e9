"""K2: the megakernel trace (csrc/mega_trace.cu), its wrapper and tables.

Replaces the Pallas megakernel of voxelray_tpu/ops/pallas/mega_trace.py
(`_make_mega_kernel` / `_mega_call`).  `trace_grid_mega` returns the
exhaustive nearest voxel hit per ray (t = +inf / lin = -1 on a miss) from
the BrickAccel's L2 superbrick bitmask and its superbrick-major fine
table `fine_sb`; an `admit` mask plus per-ray t_min / t_max make it the
shadow any-hit.

CUDA tensors launch the kernel; CPU tensors run the plain PyTorch
version, the exhaustive DDA of ops/traverse.py over the occupancy the
accel's fine words encode.  Any other device raises.  Each launch adds
1 to the counter `launches.mega_trace` (utils/trace.py).  `trace_args`
builds a launch's argument block on any device, so the host build of
the kernel (tests/) runs the same blocks.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...models.grids import pack_words, unpack_words
from ..traverse import _per_ray, trace_grid_dda
from ...utils import trace
from ._build import F, I, P, fields, launch, need, need_rays, on_cuda

__all__ = ["build_fine_sb", "trace_grid_mega", "trace_grid_mega_cuda",
           "trace_grid_mega_plain", "trace_args", "accel_occupancy",
           "MegaTraceArgs", "TILE_ROWS"]


BRICK = 8
TILE_ROWS = 72  # 64 word rows + occupancy row 64 + 7 alignment spares
# The kernel's chunks of 32 rays are dealt to this many counters in turn,
# each in its own 128-byte line (32 ints), so that a frame's ~65K fetches
# do not queue on one word (PERF.md)
STRIPES = 32


@trace.spanned("build_fine_sb")
def build_fine_sb(fine, bdims):
    """(16, NB) packed fine words -> (n_sb, 72, 128) superbrick-major.

    Layout of voxelray_tpu's build_fine_sb, bit for bit: within
    superbrick s, rows 0-63 hold word w of brick-local b at
    (w*4 + (b>>7), b&127), i.e. flat index w*512 + b; row 64 lanes 0-15
    hold the superbrick's brick-occupancy words (brick b at lane b>>5,
    bit b&31); rows 65-71 are zero.  Bricks outside bdims are zero.
    Words are int32 tensors holding the uint32 bit patterns.
    """
    bx, by, bz = bdims
    sbx, sby, sbz = -(-bx // 8), -(-by // 8), -(-bz // 8)
    n_sb = sbx * sby * sbz
    s = np.arange(n_sb)
    scx, scy, scz = s % sbx, (s // sbx) % sby, s // (sbx * sby)
    b = np.arange(512)
    gx = scx[:, None] * 8 + (b % 8)[None, :]
    gy = scy[:, None] * 8 + ((b // 8) % 8)[None, :]
    gz = scz[:, None] * 8 + (b // 64)[None, :]
    valid = (gx < bx) & (gy < by) & (gz < bz)
    nb = fine.shape[1]
    idx = np.where(valid, gx + bx * (gy + by * gz), nb).reshape(-1)
    finep = torch.cat([fine, torch.zeros((16, 1), dtype=fine.dtype,
                                         device=fine.device)], dim=1)
    words = finep[:, torch.as_tensor(idx, device=fine.device)]
    words = words.reshape(16, n_sb, 512).permute(1, 0, 2)   # (n_sb, 16, 512)
    out = torch.zeros((n_sb, TILE_ROWS, 128), dtype=torch.int32,
                      device=fine.device)
    out[:, :64] = words.reshape(n_sb, 64, 128)
    bocc = (words != 0).any(dim=1)                          # (n_sb, 512)
    out[:, 64, :16] = pack_words(bocc.reshape(n_sb, 16, 32))
    return out


def accel_occupancy(accel):
    """Dense (X*Y*Z,) uint8 occupancy decoded from the accel's fine words."""
    nx, ny, nz = accel.dims
    bx, by, bz = accel.bdims
    bits = unpack_words(accel.fine.t())                     # (NB, 16, 32)
    occ = bits.reshape(bz, by, bx, BRICK, BRICK, BRICK) \
        .permute(0, 3, 1, 4, 2, 5).reshape(bz * BRICK, by * BRICK, bx * BRICK)
    return occ[:nz, :ny, :nx].reshape(-1)


def trace_grid_mega_plain(o, d, accel, t_min, t_max, admit):
    """Plain version: (t, lin, alive) of the exhaustive DDA, same
    arguments as trace_grid_mega_cuda."""
    t, lin = trace_grid_dda(o, d, accel_occupancy(accel), accel.origin,
                            dims=accel.dims, voxel_size=accel.voxel_size,
                            t_min=t_min, t_max=t_max, admit=admit)
    return t, lin, torch.zeros_like(lin)


class MegaTraceArgs(ctypes.Structure):
    """csrc/mega_trace.cu's MegaTraceArgs."""
    SIZES = ("mega_trace_sizes", 0)
    _fields_ = fields((P, "o d t_min t_max admit l2 fine_sb"),
                      (I, "n nx ny nz bx by bz"),
                      (F, "ogx ogy ogz vs half bw"),
                      (P, "t_out lin_out alive_out next_ray"),
                      (I, "stripes"))


def trace_args(o, d, t_min, t_max, admit, accel):
    """(the argument block, (t (N,) float32, lin (N,) int32, alive (N,)
    int32)) of K2's launch, the outputs allocated on o's device,
    unwritten; the zeroed stripe counters on the block (`keep`).  o, d:
    (N, 3) float32; t_min, t_max: (N,) float32; admit: (N,) bool; the
    accel's l2 and fine_sb: contiguous, on o's device."""
    dev, n = o.device, o.shape[0]
    f32, what = torch.float32, "trace_grid_mega_cuda"
    a = MegaTraceArgs(n=n, stripes=STRIPES)
    need_rays(a, what, o, d, t_min, t_max)
    a.admit = need(what, "admit", admit, dev, torch.bool, (n,))
    bx, by, bz = accel.bdims
    a.bx, a.by, a.bz = bx, by, bz
    n_sb = (-(-bx // 8)) * (-(-by // 8)) * (-(-bz // 8))
    a.l2 = need(what, "accel.l2", accel.l2, dev, torch.int32)
    a.fine_sb = need(what, "accel.fine_sb", accel.fine_sb, dev, torch.int32,
                     (n_sb, TILE_ROWS, 128))
    if accel.l2.numel() * 32 < n_sb:
        raise ValueError(f"{what}: accel tables do not match bdims "
                         f"{accel.bdims}")
    if n >= 2 ** 30:
        raise ValueError(f"{what}: {n} rays exceed int32 ray indexing")
    a.nx, a.ny, a.nz = accel.dims
    vs = np.float32(accel.voxel_size)
    a.ogx, a.ogy, a.ogz = accel.origin_key
    a.vs, a.half = float(vs), float(np.float32(0.5) * vs)
    a.bw = float(np.float32(accel.voxel_size * BRICK))
    outs = (torch.empty((n,), dtype=f32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev))
    a.t_out, a.lin_out, a.alive_out = (x.data_ptr() for x in outs)
    a.keep = {"next_ray": torch.zeros((STRIPES * 32,), dtype=torch.int32,
                                      device=dev)}
    a.next_ray = a.keep["next_ray"].data_ptr()
    return a, outs


def trace_grid_mega_cuda(o, d, accel, t_min, t_max, admit):
    """Launch K2.  o, d: (N, 3) float32; t_min, t_max: (N,) float32;
    admit: (N,) bool; the accel's l2 and fine_sb on the same CUDA device.
    Returns (t (N,) float32, lin (N,) int32, alive (N,) int32)."""
    on_cuda("trace_grid_mega_cuda", o.device)
    a, outs = trace_args(o, d, t_min, t_max, admit, accel)
    if a.n:
        launch("mega_trace", a, o.device)
    return outs


def trace_grid_mega(origins, dirs, accel, t_min, t_max, admit=None,
                    return_stats=False):
    """One-launch exhaustive nearest-hit trace (t, cell_lin).

    origins/dirs: (..., 3) float32; t_min/t_max: scalars or per-ray
    (...) values; admit: optional bool (...) mask.  return_stats=True
    also returns `unresolved`, the number of rays still alive at the
    step cap (0 means the result is provably exhaustive).
    """
    batch = origins.shape[:-1]
    dev = origins.device
    o = origins.reshape(-1, 3).to(torch.float32).contiguous()
    d = dirs.reshape(-1, 3).to(torch.float32).contiguous()
    n = o.shape[0]
    tmn = _per_ray(t_min, n, dev).contiguous()
    tmx = _per_ray(t_max, n, dev).contiguous()
    adm = (torch.ones((n,), dtype=torch.bool, device=dev) if admit is None
           else admit.reshape(-1).to(torch.bool).contiguous())
    trace.count("rays.mega_trace", n)
    with trace.span("mega_trace"):
        if o.is_cuda:
            t, lin, alive = trace_grid_mega_cuda(o, d, accel, tmn, tmx, adm)
        elif dev.type == "cpu":
            t, lin, alive = trace_grid_mega_plain(o, d, accel, tmn, tmx,
                                                  adm)
        else:
            raise ValueError(f"trace_grid_mega: unsupported device {dev}")
    t, lin = t.reshape(batch), lin.reshape(batch)
    if return_stats:
        return t, lin, alive.sum()
    return t, lin
