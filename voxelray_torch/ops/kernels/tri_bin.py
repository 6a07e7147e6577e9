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
pass syncs: the caller reads the sizes between them.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..voxelize import _window_hits, hit_stream
from ...utils import trace
from ._build import check, load_library

__all__ = ["count", "emit", "count_plain", "emit_plain", "outside_plain",
           "check_sizes"]

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def check_sizes(dims, n_tri):
    """Raise where the grid or the triangle count exceeds the kernels'
    int32 indexing (cells, triangle ids and pair positions)."""
    nx, ny, nz = (int(x) for x in dims)
    if nx * ny * nz >= 2 ** 31:
        raise ValueError(f"tri grid {dims} exceeds int32 cell indexing")
    if n_tri >= 2 ** 31:
        raise ValueError(f"{n_tri} triangles exceed int32 indexing")


def _grid_args(origin, voxel_size, dims):
    org = np.asarray(origin, np.float32)
    return (float(org[0]), float(org[1]), float(org[2]),
            float(np.float32(voxel_size)),
            float(np.float32(voxel_size * 0.5)), *(int(x) for x in dims))


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


def _fn(name, n_float, n_ptr):
    fn = getattr(load_library(), name)
    fn.argtypes = [_vp, _ci] + [_cf] * 5 + [_ci] * 3 + [_cf] * n_float \
        + [_vp] * n_ptr
    fn.restype = _ci
    return fn


def _checked(tri9, n_tri, dims):
    if not tri9.is_cuda:
        raise ValueError("tri_bin: tri9 not on a CUDA device")
    if (tri9.dtype != torch.float32 or tri9.dim() != 2
            or tri9.shape[1] != 9 or tri9.shape[0] < n_tri
            or not tri9.is_contiguous()):
        raise ValueError(f"tri_bin: tri9 must be a contiguous (>= {n_tri}, "
                         f"9) float32 tensor, got {tuple(tri9.shape)} "
                         f"{tri9.dtype}")
    check_sizes(dims, n_tri)


def count(tri9, n_tri, origin, voxel_size, dims, lo, hi):
    """The count pass on tri9's device (module docstring)."""
    if tri9.device.type == "cpu":
        return count_plain(tri9, n_tri, origin, voxel_size, dims, lo, hi)
    if tri9.device.type != "cuda":
        raise ValueError(f"tri_bin: unsupported device {tri9.device}")
    _checked(tri9, n_tri, dims)
    dev = tri9.device
    nx, ny, nz = (int(x) for x in dims)
    tri_count = torch.empty((n_tri,), dtype=torch.int32, device=dev)
    cell_count = torch.zeros((nx * ny * nz,), dtype=torch.int32, device=dev)
    outside = torch.zeros((1,), dtype=torch.int64, device=dev)
    if n_tri:
        box = [float(x) for b in (lo, hi) for x in np.asarray(b, np.float32)]
        fn = _fn("tri_bin_count_launch", 6, 4)
        with torch.cuda.device(dev):
            err = fn(tri9.data_ptr(), n_tri,
                     *_grid_args(origin, voxel_size, dims), *box,
                     tri_count.data_ptr(), cell_count.data_ptr(),
                     outside.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
        check(err, "tri_bin_count_launch")
        trace.count("launches.tri_bin_count")
    return tri_count, cell_count, outside


def emit(tri9, n_tri, origin, voxel_size, dims, cum, n_pairs):
    """The emit pass on tri9's device (module docstring)."""
    if tri9.device.type == "cpu":
        return emit_plain(tri9, n_tri, origin, voxel_size, dims)
    if tri9.device.type != "cuda":
        raise ValueError(f"tri_bin: unsupported device {tri9.device}")
    _checked(tri9, n_tri, dims)
    dev = tri9.device
    if (cum.device != dev or cum.dtype != torch.int64
            or tuple(cum.shape) != (n_tri,) or not cum.is_contiguous()):
        raise ValueError("tri_bin: cum must be a contiguous (n_tri,) int64 "
                         "tensor on tri9's device")
    pair_tri = torch.empty((n_pairs,), dtype=torch.int32, device=dev)
    pair_lin = torch.empty((n_pairs,), dtype=torch.int32, device=dev)
    if n_tri and n_pairs:
        fn = _fn("tri_bin_emit_launch", 0, 4)
        with torch.cuda.device(dev):
            err = fn(tri9.data_ptr(), n_tri,
                     *_grid_args(origin, voxel_size, dims), cum.data_ptr(),
                     pair_tri.data_ptr(), pair_lin.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
        check(err, "tri_bin_emit_launch")
        trace.count("launches.tri_bin_emit")
    return pair_tri, pair_lin
