"""tri_bin: the triangle accel's binning (csrc/tri_bin.cu) and its wrapper.

Replaces no Pallas kernel (csrc/tri_bin.cu says why it exists).  Two
passes over every triangle's clamped window in the tri grid, with K1's
window and SAT:

  count(tri9, ...)   (tri_count (F,) int32: each triangle's hits,
                      cell_count (X*Y*Z,) int32: each cell's hits,
                      outside (1,) int64: the triangles with a coordinate
                      outside the box [lo, hi] or not a number)
  emit(tri9, ..., cum, n_pairs)
                     (pair_tri, pair_lin) (n_pairs,) int32: every SAT hit
                      in serial emission order, ops/voxelize.hit_stream's;
                      cum is the inclusive scan of tri_count (int64) and
                      n_pairs its last entry

tri9 is the accel's (F + 1, 9) float32 triangle table (row F the pad);
rows past `n_tri` are not read.  CUDA tensors launch the kernels, each
launch adding 1 to the counter `launches.tri_bin_count` or
`launches.tri_bin_emit` (utils/trace.py); CPU tensors run the plain
PyTorch versions (`count_plain`, `emit_plain`, which take any device and
are the kernels' bit-for-bit reference); other devices raise.  Neither
pass syncs: the caller reads the sizes between them.  `bin_args` builds
a pass's argument block on any device, so the host build of the kernels
(tests/) runs the same blocks.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..voxelize import _window_hits, hit_stream
# K1's: the kernels index cells, triangle ids and pair positions in int32
from .voxel_accum import check_sizes
from ._build import F, I, P, fields, launch, need

__all__ = ["count", "emit", "count_plain", "emit_plain", "outside_plain",
           "check_sizes", "bin_args", "TriBinArgs"]


class TriBinArgs(ctypes.Structure):
    """csrc/tri_bin.cu's TriBinArgs."""
    SIZES = ("tri_bin_sizes", 0)
    _fields_ = fields((P, "tri"), (I, "n_tri"), (F, "ogx ogy ogz vs half"),
                      (I, "nx ny nz"), (F, "lox loy loz hix hiy hiz"),
                      (P, "tri_count cell_count outside cum pair_tri "
                           "pair_lin"))


def _tri_rows(tri9, n_tri):
    return tri9[:n_tri].reshape(n_tri, 3, 3)


def count_plain(tri9, n_tri, origin, voxel_size, dims, lo, hi):
    """The count pass in plain PyTorch on tri9's device (it syncs: the
    window slots are sized on the host)."""
    dev = tri9.device
    nx, ny, nz = dims
    tri = _tri_rows(tri9, n_tri)
    tri_count = torch.zeros((n_tri,), dtype=torch.int64, device=dev)
    cell_count = torch.zeros((nx * ny * nz,), dtype=torch.int64, device=dev)
    for t, lin, hit in _window_hits(tri, origin, voxel_size, dims):
        tri_count += torch.bincount(t[hit], minlength=n_tri)
        cell_count += torch.bincount(lin[hit], minlength=nx * ny * nz)
    return (tri_count.to(torch.int32), cell_count.to(torch.int32),
            outside_plain(tri9, n_tri, lo, hi))


def outside_plain(tri9, n_tri, lo, hi):
    """(1,) int64: the triangles with a coordinate outside [lo, hi] or not
    a number (which fails both comparisons)."""
    box = [torch.as_tensor(np.asarray(b, np.float32), device=tri9.device)
           for b in (lo, hi)]
    tri = _tri_rows(tri9, n_tri)
    inside = ((tri >= box[0]) & (tri <= box[1])).flatten(1).all(dim=1)
    return (~inside).sum().reshape(1)


def emit_plain(tri9, n_tri, origin, voxel_size, dims, cum=None,
               n_pairs=None):
    """The emit pass in plain PyTorch: hit_stream's pairs as int32 (cum
    and n_pairs, the kernel's sizes, are not needed)."""
    t, lin = hit_stream(_tri_rows(tri9, n_tri), origin, voxel_size, dims)
    return t.to(torch.int32), lin.to(torch.int32)


def bin_args(tri9, n_tri, origin, voxel_size, dims, lo=None, hi=None,
             cum=None, n_pairs=0):
    """(the argument block, outputs) of a pass on tri9's device: with the
    box lo, hi the count pass's, (tri_count, cell_count, outside) (the
    last two zeroed), else the emit pass's over cum, (pair_tri, pair_lin)
    of n_pairs each; outputs unwritten.  tri9: a contiguous (>= n_tri, 9)
    float32 tensor; cum: a contiguous (n_tri,) int64 tensor on its
    device."""
    dev = tri9.device
    if tri9.dim() != 2 or tri9.shape[1] != 9 or tri9.shape[0] < n_tri:
        raise ValueError(f"tri_bin: tri9 must be a contiguous (>= {n_tri}, "
                         f"9) float32 tensor, got {tuple(tri9.shape)} "
                         f"{tri9.dtype}")
    check_sizes(dims, n_tri)
    a = TriBinArgs(tri=need("tri_bin", "tri9", tri9, dev, torch.float32),
                   n_tri=n_tri)
    a.ogx, a.ogy, a.ogz = (float(x) for x in np.asarray(origin, np.float32))
    a.vs = float(np.float32(voxel_size))
    a.half = float(np.float32(voxel_size * 0.5))
    nx, ny, nz = (int(x) for x in dims)
    a.nx, a.ny, a.nz = nx, ny, nz
    i32 = torch.int32
    if cum is None:
        a.lox, a.loy, a.loz = (float(x) for x in np.asarray(lo, np.float32))
        a.hix, a.hiy, a.hiz = (float(x) for x in np.asarray(hi, np.float32))
        outs = (torch.empty((n_tri,), dtype=i32, device=dev),
                torch.zeros((nx * ny * nz,), dtype=i32, device=dev),
                torch.zeros((1,), dtype=torch.int64, device=dev))
        a.tri_count, a.cell_count, a.outside = (x.data_ptr() for x in outs)
    else:
        a.cum = need("tri_bin", "cum", cum, dev, torch.int64, (n_tri,))
        outs = (torch.empty((n_pairs,), dtype=i32, device=dev),
                torch.empty((n_pairs,), dtype=i32, device=dev))
        a.pair_tri, a.pair_lin = (x.data_ptr() for x in outs)
    return a, outs


def count(tri9, n_tri, origin, voxel_size, dims, lo, hi):
    """The count pass on tri9's device (module docstring)."""
    if tri9.device.type == "cpu":
        return count_plain(tri9, n_tri, origin, voxel_size, dims, lo, hi)
    if tri9.device.type != "cuda":
        raise ValueError(f"tri_bin: unsupported device {tri9.device}")
    a, outs = bin_args(tri9, n_tri, origin, voxel_size, dims, lo, hi)
    if n_tri:
        launch("tri_bin_count", a, tri9.device)
    return outs


def emit(tri9, n_tri, origin, voxel_size, dims, cum, n_pairs):
    """The emit pass on tri9's device (module docstring)."""
    if tri9.device.type == "cpu":
        return emit_plain(tri9, n_tri, origin, voxel_size, dims)
    if tri9.device.type != "cuda":
        raise ValueError(f"tri_bin: unsupported device {tri9.device}")
    a, outs = bin_args(tri9, n_tri, origin, voxel_size, dims, cum=cum,
                       n_pairs=n_pairs)
    if n_tri and n_pairs:
        launch("tri_bin_emit", a, tri9.device)
    return outs
