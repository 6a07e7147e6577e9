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
sync and raises if that count is not 0.  `accumulate` launches and
reads nothing back (voxelize_planned in ops/voxelize.py, the sharded
voxelize).  `accum_args` builds a launch's argument block on any
device, so the host build of the kernel (tests/) runs the same blocks.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..voxelize import voxelize_plain
from ._build import F, I, P, fields, launch, need, on_cuda

__all__ = ["voxel_accum", "voxel_accum_cuda", "accumulate", "accum_args",
           "check_sizes", "VoxelAccumArgs", "voxelize_plain"]


class VoxelAccumArgs(ctypes.Structure):
    """csrc/voxel_accum.cu's VoxelAccumArgs."""
    SIZES = ("voxel_accum_sizes", 0)
    _fields_ = fields((P, "v f"), (I, "n_tri n_vert"),
                      (F, "ogx ogy ogz vs half"), (I, "nx ny nz"),
                      (P, "occ counts"))


def check_sizes(dims, n_faces):
    """Raise where the grid or the face count exceeds K1's int32
    indexing."""
    nx, ny, nz = (int(x) for x in dims)
    if nx * ny * nz >= 2**31:
        raise ValueError(f"grid {dims} exceeds int32 cell indexing")
    if n_faces >= 2 ** 31:
        raise ValueError(f"{n_faces} faces exceed int32 indexing")


def accum_args(v, f, origin, voxel_size, dims):
    """(the argument block, (occ (Z, Y, X) uint8, counts (2,) int64), both
    zeroed on v's device).  v (V, 3) float32 and f (F, 3) int32,
    contiguous, on one device."""
    dev = v.device
    a = VoxelAccumArgs(
        v=need("voxel_accum", "v", v, dev, torch.float32, (v.shape[0], 3)),
        f=need("voxel_accum", "f", f, dev, torch.int32, (f.shape[0], 3)),
        n_tri=f.shape[0], n_vert=v.shape[0])
    check_sizes(dims, f.shape[0])
    a.nx, a.ny, a.nz = (int(x) for x in dims)
    a.ogx, a.ogy, a.ogz = (float(x) for x in np.asarray(origin, np.float32))
    a.vs = float(np.float32(voxel_size))
    a.half = float(np.float32(voxel_size * 0.5))
    occ = torch.zeros((a.nz, a.ny, a.nx), dtype=torch.uint8, device=dev)
    counts = torch.zeros((2,), dtype=torch.int64, device=dev)
    a.occ, a.counts = occ.data_ptr(), counts.data_ptr()
    return a, (occ, counts)


def accumulate(v, f, origin, voxel_size, dims):
    """Launch K1 (arguments as accum_args', on a CUDA device) and read
    nothing back: (occ, counts = (set_calls, faces out of range))."""
    on_cuda("voxel_accum", v.device)
    a, (occ, counts) = accum_args(v, f, origin, voxel_size, dims)
    if a.n_tri and occ.numel():
        launch("voxel_accum", a, v.device)
    return occ, counts


def voxel_accum_cuda(v, f, origin, voxel_size, dims):
    """Launch K1.  v (V, 3) float32 and f (F, 3) int32, contiguous, on one
    CUDA device; returns (occ (Z, Y, X) uint8, set_calls int)."""
    occ, counts = accumulate(v, f, origin, voxel_size, dims)
    if f.shape[0] == 0 or occ.numel() == 0:
        return occ, 0
    calls, bad = counts.tolist()
    if bad:
        raise ValueError(f"{bad} faces index a vertex out of range")
    return occ, calls


def voxel_accum(v, f, origin, voxel_size, dims):
    """Voxelize on v's device: the kernel on CUDA, the plain version on
    the CPU."""
    if v.is_cuda:
        return voxel_accum_cuda(v, f, origin, voxel_size, dims)
    if v.device.type == "cpu":
        return voxelize_plain(v, f, origin, voxel_size, dims)
    raise ValueError(f"voxel_accum: unsupported device {v.device}")
