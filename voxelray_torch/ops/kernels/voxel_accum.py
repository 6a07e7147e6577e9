"""K1: the voxelizer kernel (csrc/voxel_accum.cu) and its wrapper.

Replaces the Pallas slab-accumulation kernel of
voxelray_tpu/ops/pallas/voxel_accum.py (`_make_kernel` / `_accum_call`).
Same contract as `voxelize_mesh`: occupancy (Z, Y, X) uint8 and the
exact SAT hit total set_calls, for a mesh given as vertices and faces on
the device (no host plan).

`voxel_accum` launches the kernel for CUDA tensors and runs the plain
PyTorch version (`voxelize_plain`) for CPU tensors; any other device
raises.  Each launch adds 1 to the counter `launches.voxel_accum`
(utils/trace.py).  The kernel checks the face indices itself; the
wrapper reads its hit total and its count of out-of-range faces in one
sync and raises if that count is not 0.
`voxelize_planned` (ops/voxelize.py) calls `launch` on faces its plan
checked once, and reads nothing back.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..voxelize import voxelize_plain
from ...utils import trace
from ._build import check, load_library

__all__ = ["voxel_accum", "voxel_accum_cuda", "launch", "check_sizes",
           "voxelize_plain"]

_c_void = ctypes.c_void_p
_c_int = ctypes.c_int
_c_float = ctypes.c_float


def _lib():
    lib = load_library()
    fn = lib.voxel_accum_launch
    fn.argtypes = [_c_void, _c_void, _c_int, _c_int,
                   _c_float, _c_float, _c_float, _c_float, _c_float,
                   _c_int, _c_int, _c_int, _c_void, _c_void, _c_void]
    fn.restype = _c_int
    return fn


def voxel_accum_cuda(v, f, origin, voxel_size, dims):
    """Launch K1.  v (V, 3) float32 and f (F, 3) int32, contiguous, on one
    CUDA device; returns (occ (Z, Y, X) uint8, set_calls int)."""
    if not (v.is_cuda and f.is_cuda and v.device == f.device):
        raise ValueError("voxel_accum_cuda needs v and f on one CUDA device")
    if v.dtype != torch.float32 or v.dim() != 2 or v.shape[1] != 3:
        raise ValueError(f"v must be (V, 3) float32, got {tuple(v.shape)} "
                         f"{v.dtype}")
    if f.dtype != torch.int32 or f.dim() != 2 or f.shape[1] != 3:
        raise ValueError(f"f must be (F, 3) int32, got {tuple(f.shape)} "
                         f"{f.dtype}")
    if not (v.is_contiguous() and f.is_contiguous()):
        raise ValueError("v and f must be contiguous")
    check_sizes(dims, f.shape[0])
    nx, ny, nz = (int(x) for x in dims)
    occ = torch.zeros((nz, ny, nx), dtype=torch.uint8, device=v.device)
    counts = torch.zeros((2,), dtype=torch.int64, device=v.device)
    if f.shape[0] == 0 or occ.numel() == 0:
        return occ, 0
    launch(v, f, origin, voxel_size, dims, occ, counts)
    calls, bad = counts.tolist()
    if bad:
        raise ValueError(f"{bad} faces index a vertex out of range")
    return occ, calls


def check_sizes(dims, n_faces):
    """Raise where the grid or the face count exceeds K1's int32
    indexing."""
    nx, ny, nz = (int(x) for x in dims)
    if nx * ny * nz >= 2**31:
        raise ValueError(f"grid {dims} exceeds int32 cell indexing")
    if n_faces >= 2 ** 31:
        raise ValueError(f"{n_faces} faces exceed int32 indexing")


def launch(v, f, origin, voxel_size, dims, occ, counts):
    """Launch K1 on checked arguments (see voxel_accum_cuda): ORs the
    mesh's occupancy into occ (Z, Y, X) uint8 and adds the hit total and
    the number of out-of-range faces to counts (2,) int64."""
    nx, ny, nz = (int(x) for x in dims)
    org = np.asarray(origin, np.float32)
    fn = _lib()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(v.data_ptr(), f.data_ptr(), int(f.shape[0]),
                 int(v.shape[0]), float(org[0]), float(org[1]),
                 float(org[2]), float(np.float32(voxel_size)),
                 float(np.float32(voxel_size * 0.5)),
                 nx, ny, nz, occ.data_ptr(), counts.data_ptr(), stream)
    check(err, "voxel_accum_launch")
    trace.count("launches.voxel_accum")


def voxel_accum(v, f, origin, voxel_size, dims):
    """Voxelize on v's device: the kernel on CUDA, the plain version on
    the CPU."""
    if v.is_cuda:
        return voxel_accum_cuda(v, f, origin, voxel_size, dims)
    if v.device.type == "cpu":
        return voxelize_plain(v, f, origin, voxel_size, dims)
    raise ValueError(f"voxel_accum: unsupported device {v.device}")
