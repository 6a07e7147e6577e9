"""accel_build: a voxel grid's brick accel tables and its boxes on the card
(csrc/accel_build.cu), and their wrappers.

Replaces no Pallas kernel (csrc/accel_build.cu says why it exists):

  accel_tables(occ, bdims, fine_sb)
        (fine, coarse, l2, fine_sb or None): every table of the BrickAccel
        of a (Z, Y, X) uint8 occupancy, a cell any nonzero byte, from one
        call (two kernels: the words over the occupancy, then the
        superbrick tiles' occupancy rows and l2 from coarse)
  aabb_boxes(lin, dims, origin, voxel_size)
        (N, 6) float32 boxes of N linear cell indices

Their plain versions are the PyTorch build in ops/traverse_fast.py
(_bricks, _fine_words, _bitmask_rows, _l2 and mega_trace.build_fine_sb)
and ops/aabbs.aabbs_from_linear, which CPU tensors run; the kernels give
their values bit for bit.  Neither call syncs or copies from the host:
the origin and the cell size go to the kernel by value.  accel_args and
box_args build a launch's argument block on any device, so the host
build of the kernels (tests/) runs the same blocks.  Each call adds 1 to
the counter `launches.accel_build` or `launches.aabb_boxes`
(utils/trace.py).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import F, I, P, fields, launch, on_cuda

__all__ = ["accel_tables", "aabb_boxes", "accel_args", "box_args",
           "AccelArgs", "BoxArgs", "TILE_ROWS"]

TILE_ROWS = 72  # a superbrick tile: 64 word rows, the occupancy row, 7 zero


class AccelArgs(ctypes.Structure):
    """csrc/accel_build.cu's AccelArgs."""
    SIZES = ("accel_build_sizes", 0)
    _fields_ = fields((P, "occ"),
                      (I, "nx ny nz bx by bz sbx sby sbz nb coarse_words "
                           "l2_words"),
                      (P, "fine coarse l2 tiles"))


class BoxArgs(ctypes.Structure):
    """csrc/accel_build.cu's BoxArgs."""
    SIZES = ("accel_build_sizes", 1)
    _fields_ = fields((P, "lin"), (I, "n nx ny"),
                      (F, "ogx ogy ogz vs half"), (P, "boxes"))


def _rows(n_bits):
    """Rows of 128 words that hold n_bits bits, at least one
    (traverse_fast._bitmask_rows)."""
    n_words = -(-n_bits // 32)
    return max(1, -(-n_words // 128))


def accel_args(occ, bdims, fine_sb):
    """(the argument block, (fine, coarse, l2, fine_sb or None)): the
    tables allocated on occ's device, unwritten.  occ: a contiguous (Z, Y,
    X) uint8 tensor."""
    nz, ny, nx = occ.shape
    bx, by, bz = bdims
    sbx, sby, sbz = -(-bx // 8), -(-by // 8), -(-bz // 8)
    nb, n_sb = bx * by * bz, sbx * sby * sbz
    dev = occ.device
    fine = torch.empty((16, nb), dtype=torch.int32, device=dev)
    coarse = torch.empty((_rows(nb), 128), dtype=torch.int32, device=dev)
    l2 = torch.empty((_rows(n_sb), 128), dtype=torch.int32, device=dev)
    tiles = (torch.empty((n_sb, TILE_ROWS, 128), dtype=torch.int32,
                         device=dev) if fine_sb else None)
    a = AccelArgs(occ.data_ptr(), nx, ny, nz, bx, by, bz, sbx, sby, sbz, nb,
                  coarse.numel(), l2.numel(), fine.data_ptr(),
                  coarse.data_ptr(), l2.data_ptr(),
                  tiles.data_ptr() if fine_sb else None)
    return a, (fine, coarse, l2, tiles)


def box_args(lin, dims, origin, voxel_size):
    """(the argument block, the (N, 6) float32 boxes allocated on lin's
    device, unwritten).  lin: a contiguous (N,) int64 tensor; origin three
    floats (rounded to float32, as aabbs_from_cells rounds them)."""
    nx, ny, _ = (int(x) for x in dims)
    n = lin.shape[0]
    org = np.asarray(origin, np.float32)
    boxes = torch.empty((n, 6), dtype=torch.float32, device=lin.device)
    a = BoxArgs(lin.data_ptr(), n, nx, ny, *(float(x) for x in org),
                float(np.float32(voxel_size)),
                float(np.float32(0.5) * np.float32(voxel_size)),
                boxes.data_ptr())
    return a, boxes


def accel_tables(occ, bdims, fine_sb):
    """The BrickAccel tables of occ, a (Z, Y, X) CUDA tensor (uint8; another
    dtype is cast to uint8, as the PyTorch build casts it), bdims its brick
    dims (X, Y, Z): (fine (16, NB), coarse, l2, fine_sb (n_sb, 72, 128) or
    None), int32, on occ's device."""
    on_cuda("accel_build", occ.device)
    if occ.dim() != 3:
        raise ValueError(f"accel_build: occ must be (Z, Y, X), got "
                         f"{tuple(occ.shape)}")
    occ = occ.to(torch.uint8).contiguous()
    if 16 * bdims[0] * bdims[1] * bdims[2] >= 2 ** 31:
        raise ValueError(f"accel_build: {bdims} bricks exceed int32 "
                         "indexing")
    a, tables = accel_args(occ, bdims, fine_sb)
    launch("accel_build", a, occ.device)
    return tables


def aabb_boxes(lin, dims, origin, voxel_size):
    """(..., 6) float32 boxes of the linear cell indices lin, a CUDA
    tensor, in aabbs_from_cells' float32 expressions, on lin's device.
    origin: three floats, or a tensor (read on the host)."""
    on_cuda("aabb_boxes", lin.device)
    if lin.numel() >= 2 ** 31:
        raise ValueError(f"aabb_boxes: {lin.numel()} cells exceed int32 "
                         "indexing")
    if torch.is_tensor(origin):
        origin = origin.detach().cpu().numpy()
    shape = lin.shape
    lin = lin.reshape(-1).to(torch.int64).contiguous()
    a, boxes = box_args(lin, dims, origin, voxel_size)
    if a.n:
        launch("aabb_boxes", a, lin.device)
    return boxes.reshape(*shape, 6)
