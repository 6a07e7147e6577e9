"""Morton (Z-order) encode/decode for the octree encoding.

Counterpart of voxelray_tpu/ops/morton.py.  The reference interleaves 21
bits per axis into a 64-bit code (src/octTree.hpp:21-127, 211-218; bit
3k = x_k, 3k+1 = y_k, 3k+2 = z_k) and decodes with a magic-bits
compaction (octTree.hpp:220-238).  The numpy functions are copies of the
JAX package's.  On tensors the codes are int64: a 63-bit code is a
non-negative int64, so torch's signed sort gives the uint64 order and no
(hi, lo) limb pair is needed; `sort_codes_device` still sorts JAX's limb
pairs in JAX's order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["morton_encode3", "morton_decode3", "morton_encode3_np",
           "morton_decode3_np", "spread_bits_np", "sort_codes_device"]


def spread_bits_np(v: np.ndarray) -> np.ndarray:
    """Insert two zero bits between each of the low 21 bits (uint64)."""
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def _compact_bits_np(v: np.ndarray) -> np.ndarray:
    """Inverse of spread_bits_np (the reference's compactBits,
    octTree.hpp:220-238)."""
    v = v.astype(np.uint64) & np.uint64(0x1249249249249249)
    v = (v ^ (v >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
    v = (v ^ (v >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
    v = (v ^ (v >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
    v = (v ^ (v >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
    v = (v ^ (v >> np.uint64(32))) & np.uint64(0x1FFFFF)
    return v


def morton_encode3_np(x, y, z) -> np.ndarray:
    """uint64 Morton codes with the bit layout of morton3D
    (octTree.hpp:211-218)."""
    return (spread_bits_np(np.asarray(x))
            | (spread_bits_np(np.asarray(y)) << np.uint64(1))
            | (spread_bits_np(np.asarray(z)) << np.uint64(2)))


def morton_decode3_np(code):
    code = np.asarray(code, dtype=np.uint64)
    return (_compact_bits_np(code),
            _compact_bits_np(code >> np.uint64(1)),
            _compact_bits_np(code >> np.uint64(2)))


def _spread21(v):
    """spread_bits_np on int64 tensors: every intermediate stays below
    2^63, so the signed arithmetic is the unsigned one."""
    v = v.to(torch.int64) & 0x1FFFFF
    v = (v | (v << 32)) & 0x1F00000000FFFF
    v = (v | (v << 16)) & 0x1F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    v = (v | (v << 2)) & 0x1249249249249249
    return v


def _compact21(v):
    v = v & 0x1249249249249249
    v = (v ^ (v >> 2)) & 0x10C30C30C30C30C3
    v = (v ^ (v >> 4)) & 0x100F00F00F00F00F
    v = (v ^ (v >> 8)) & 0x1F0000FF0000FF
    v = (v ^ (v >> 16)) & 0x1F00000000FFFF
    v = (v ^ (v >> 32)) & 0x1FFFFF
    return v


def morton_encode3(x, y, z):
    """Device encode of integer coordinate tensors (21 bits each) ->
    int64 63-bit codes, bit-identical to morton_encode3_np."""
    return _spread21(x) | (_spread21(y) << 1) | (_spread21(z) << 2)


def morton_decode3(code):
    """Device decode of int64 codes -> (x, y, z) int64 tensors."""
    code = code.to(torch.int64)
    return _compact21(code), _compact21(code >> 1), _compact21(code >> 2)


def _limb(x, device):
    """uint32 limb values as an int64 tensor (int32 bit patterns read as
    unsigned)."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x).astype(np.int64), device=device)
    return x.to(torch.int64) & 0xFFFFFFFF


def sort_codes_device(hi, lo, device=None):
    """Lexicographic sort of (hi, lo) uint32 Morton limb pairs, hi major:
    the order jax.lax.sort((hi, lo), num_keys=2) gives
    (voxelray_tpu/ops/morton.py:91), so the (0xFFFFFFFF, 0xFFFFFFFF)
    sentinel sorts last.  A stable sort by lo, then a stable sort by hi
    (an int64 key hi << 32 | lo would turn the sentinel negative).

    hi, lo: tensors (sorted on their device) or numpy arrays (sorted on
    `device`, default the CUDA card).  Returns the sorted (hi, lo) as
    int64 tensors holding the uint32 values.
    """
    if not torch.is_tensor(hi):
        device = resolve_device(device)
    hi = _limb(hi, device)
    lo = _limb(lo, hi.device)
    order = torch.argsort(lo, stable=True)
    order = order[torch.argsort(hi[order], stable=True)]
    return hi[order], lo[order]
