"""AABB extraction, the getAabbs() equivalents, on torch tensors.

Counterpart of voxelray_tpu/ops/aabbs.py.  The reference walks its
encodings on the CPU and emits a std::vector<Aabb> in ascending linear
index order (voxelgridBool.cpp:18-52 bit-scan).  Here the rows come from
a stream compaction of the packed words on the tensors' device: a
popcount per 8-cell byte of the words (a 256-entry table), an inclusive
prefix sum over the bytes, and for output row r the byte holding the
r-th set bit (a binary search of the prefix sum) and the bit within it
(a 256 x 8 table).  No dense occupancy volume is unpacked and nothing
waits on the host: the fixed extraction returns a (capacity, 6) buffer
and the count as tensors.

Output contract (shared with the JAX package): rows in ascending linear
index, zero rows beyond the rows placed, and `count` equal to the FULL
popcount even where a bound drops rows, so count > rows placed is the
caller's overflow signal.  The word / byte / group bounds are the JAX
package's truncation rules: the rows kept are the cells of the first
`group_capacity` nonzero 8-word groups, of those the first
`word_capacity` nonzero words, of those the first `byte_capacity`
nonzero bytes, and at most `capacity` rows.  On this device they bound
no buffer; they only drop the tail.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import trace
from .kernels import accel_build

__all__ = ["aabbs_from_linear", "aabbs_from_linear_plain", "aabbs_from_cells",
           "extract_aabbs_fixed", "extract_aabbs_words", "extract_aabbs",
           "count_occupied", "count_nonzero_words", "count_nonzero_bytes",
           "count_nonzero_groups"]

_GROUP = 8          # words per group of the group bound


def _origin(origin, device):
    if torch.is_tensor(origin):
        return origin.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(origin, np.float32), device=device)


def aabbs_from_cells(x, y, z, origin, voxel_size):
    """Integer cell coordinate tensors -> (N, 6) float32 AABBs [min | max].

    Centre = origin + (coords + 0.5) * voxelSize, corners = centre -/+
    half (voxelgridBool.cpp:34-43), the float32 expressions of the JAX
    package as written.
    """
    vs = float(np.float32(voxel_size))
    half = float(np.float32(0.5) * np.float32(voxel_size))
    org = _origin(origin, x.device)
    f32 = torch.float32
    cx = org[0] + (x.to(f32) + 0.5) * vs
    cy = org[1] + (y.to(f32) + 0.5) * vs
    cz = org[2] + (z.to(f32) + 0.5) * vs
    return torch.stack([cx - half, cy - half, cz - half,
                        cx + half, cy + half, cz + half], dim=-1)


def aabbs_from_linear(lin, dims, origin, voxel_size):
    """Linear cell indices -> (N, 6) float32 AABBs: on CUDA tensors one
    aabb_boxes launch (ops/kernels/accel_build.py), elsewhere
    aabbs_from_linear_plain, its bit-for-bit reference."""
    if lin.is_cuda:
        return accel_build.aabb_boxes(lin, dims, origin, voxel_size)
    return aabbs_from_linear_plain(lin, dims, origin, voxel_size)


def aabbs_from_linear_plain(lin, dims, origin, voxel_size):
    """aabbs_from_cells of linear cell indices, in PyTorch ops on lin's
    device."""
    nx, ny, _ = dims
    lin = lin.to(torch.int64)
    return aabbs_from_cells(lin % nx, (lin // nx) % ny, lin // (nx * ny),
                            origin, voxel_size)


_BYTE_POP = [bin(b).count("1") for b in range(256)]
# _BYTE_BIT[b][k]: the position of the k-th set bit of byte b
_BYTE_BIT = [[j for j in range(8) if b >> j & 1] + [0] * (8 - _BYTE_POP[b])
             for b in range(256)]


def _bytes_of(w):
    """int64 words in [0, 2^32) -> (their bytes in linear order, each
    byte's set bits)."""
    sh = torch.arange(0, 32, 8, dtype=torch.int64, device=w.device)
    bytes_ = ((w[:, None] >> sh) & 0xFF).reshape(-1)
    pop_t = torch.tensor(_BYTE_POP, dtype=torch.int64, device=w.device)
    return bytes_, pop_t[bytes_]


def _u32_words(words):
    """int32 (uint32 bit pattern) or int64 words -> int64 in [0, 2^32)."""
    return words.to(torch.int64) & 0xFFFFFFFF


def _words_from_occ(occ):
    """Dense occupancy (any shape, flattened in linear order) -> int64
    words, bit idx%32 of word idx/32."""
    flat = occ.reshape(-1) != 0
    n = flat.shape[0]
    nw = -(-n // 32)
    bits = torch.zeros(nw * 32, dtype=torch.int64, device=flat.device)
    bits[:n] = flat.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=flat.device)
    return (bits.reshape(nw, 32) << shifts).sum(dim=1)


def _kept_bits(pops, capacity, word_capacity, byte_capacity,
               group_capacity):
    """Set bits admitted by the group / word / byte bounds (a tensor),
    from the bytes' set bits."""
    wpops = pops.reshape(-1, 4).sum(dim=1)
    nw = wpops.shape[0]
    adm = wpops != 0
    if group_capacity is not None:
        nwg = -(-nw // _GROUP)
        gcap = max(1, min(nwg, group_capacity))
        padded = torch.zeros(nwg * _GROUP, dtype=torch.bool,
                             device=pops.device)
        padded[:nw] = adm
        gnz = padded.reshape(nwg, _GROUP).any(dim=1)
        gadm = gnz & (torch.cumsum(gnz.to(torch.int64), 0) <= gcap)
        adm = adm & gadm.repeat_interleave(_GROUP)[:nw]
    wcap = min(nw, capacity if word_capacity is None else word_capacity)
    adm = adm & (torch.cumsum(adm.to(torch.int64), 0) <= wcap)
    if byte_capacity is None:
        return (wpops * adm).sum()
    bnz = (pops != 0) & adm.repeat_interleave(4)
    bcap = min(4 * wcap, max(1, byte_capacity))
    badm = bnz & (torch.cumsum(bnz.to(torch.int64), 0) <= bcap)
    return (pops * badm).sum()


def _extract_from_words(w, origin, *, capacity, dims, voxel_size,
                        word_capacity, byte_capacity, group_capacity):
    dev = w.device
    if w.shape[0] == 0:
        return (torch.zeros((capacity, 6), dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    bytes_, pops = _bytes_of(w)
    cum = torch.cumsum(pops, 0)                 # inclusive prefix popcount
    count = cum[-1]                             # the FULL popcount
    # the bounds keep a prefix of the set bits in linear order, so row r
    # is the r-th set bit overall and the rows past the kept ones are zero
    valid_n = count
    if (word_capacity, byte_capacity, group_capacity) != (None,) * 3:
        valid_n = torch.minimum(count, _kept_bits(
            pops, capacity, word_capacity, byte_capacity, group_capacity))
    r = torch.arange(capacity, dtype=torch.int64, device=dev)
    bi = torch.clamp(torch.searchsorted(cum, r, right=True),
                     max=bytes_.shape[0] - 1)
    k = torch.clamp(r - (cum[bi] - pops[bi]), 0, 7)
    bit_t = torch.tensor(_BYTE_BIT, dtype=torch.int64, device=dev)
    lin = bi * 8 + bit_t[bytes_[bi], k]
    boxes = aabbs_from_linear(lin, dims, origin, voxel_size)
    valid = r < valid_n
    return torch.where(valid[:, None], boxes, torch.zeros_like(boxes)), count


def extract_aabbs_fixed(occ, origin, *, capacity, dims, voxel_size,
                        word_capacity=None, byte_capacity=None,
                        group_capacity=None):
    """Occupancy (Z, Y, X) tensor -> ((capacity, 6) float32, count) on
    its device, without a host sync.  Rows beyond the placed ones are
    zero; count is the full number of occupied cells."""
    return _extract_from_words(
        _words_from_occ(occ), origin, capacity=capacity, dims=dims,
        voxel_size=voxel_size, word_capacity=word_capacity,
        byte_capacity=byte_capacity, group_capacity=group_capacity)


def extract_aabbs_words(words, origin, *, capacity, dims, voxel_size,
                        word_capacity=None, byte_capacity=None,
                        group_capacity=None):
    """extract_aabbs_fixed from GridBool's packed words (int32 tensors
    holding the uint32 bits; padding bits beyond the cells zero)."""
    return _extract_from_words(
        _u32_words(words), origin, capacity=capacity, dims=dims,
        voxel_size=voxel_size, word_capacity=word_capacity,
        byte_capacity=byte_capacity, group_capacity=group_capacity)


def _flat_bool(occ):
    return torch.as_tensor(np.asarray(occ) if not torch.is_tensor(occ)
                           else occ).reshape(-1) != 0


def _chunks_nonzero(occ, cells):
    """Nonzero `cells`-cell chunks of the flattened occupancy."""
    flat = _flat_bool(occ)
    n = flat.shape[0]
    if n == 0:
        return 0
    m = -(-n // cells)
    padded = torch.zeros(m * cells, dtype=torch.bool, device=flat.device)
    padded[:n] = flat
    return int(padded.reshape(m, cells).any(dim=1).sum())


def count_occupied(occ) -> int:
    return int(_flat_bool(occ).sum())


def count_nonzero_words(occ) -> int:
    """Nonzero 32-cell words: the stats source for word_capacity."""
    return _chunks_nonzero(occ, 32)


def count_nonzero_groups(occ) -> int:
    """Nonzero 8-word (256-cell) groups: the stats source for
    group_capacity."""
    return _chunks_nonzero(occ, 32 * _GROUP)


def count_nonzero_bytes(occ) -> int:
    """Nonzero 8-cell bytes: the stats source for byte_capacity."""
    return _chunks_nonzero(occ, 8)


@trace.spanned("extract_aabbs")
def extract_aabbs(grid):
    """Exact-size (N, 6) float32 rows, in linear order, from a
    voxelize_mesh result dict or a grid object (occupancy(), dims,
    origin, voxel_size), on the occupancy's device.  On the card the
    `nonzero` that sizes the rows is the one host sync; the rows are one
    aabb_boxes launch."""
    if isinstance(grid, dict):
        occ, dims = grid["occ"], grid["dims"]
        origin, vs = grid["origin"], grid["voxel_size"]
    else:
        occ, dims = grid.occupancy(), grid.dims
        origin, vs = grid.origin, grid.voxel_size
    flat = torch.as_tensor(occ).reshape(-1)
    lin = torch.nonzero(flat).reshape(-1)
    return aabbs_from_linear(lin, dims, origin, vs)
