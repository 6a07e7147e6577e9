"""The voxel-grid encodings on torch tensors.

Counterpart of voxelray_tpu/models/grids.py:
  GridBool       <- VoxelGridBool (src/voxelgridBool.{hpp,cpp}): 1 bit per
                    cell packed into 32-bit words, word = idx/32,
                    bit = idx%32.
  GridAabbStruct <- VoxelGridAABBstruct (src/voxelgridAABBstruct.{hpp,cpp}):
                    dense per-cell {min, max, isUsed}, 28 B per cell.
  GridVec        <- VoxelGridVec (src/voxelgridVecEncoding.{hpp,cpp}):
                    append-only AABB list, duplicates kept in setVoxel
                    call order.
The fourth encoding, the Morton octree, is models/octree.py.

All share the base grid of VoxelGrid<T> (src/voxelgrid.hpp): linear
index x + X*(y + Y*z), cell centres origin + (idx + 0.5) * size,
out-of-bounds access raises IndexError, and a set_calls counter of
setVoxel calls (SAT hits, duplicates included).  memory_usage_bytes is
getMemoryUsageBytes (voxelgrid.hpp:115-122): element count times the C++
element size, not the tensors' bytes.

PyTorch has no general uint32 arithmetic, so GridBool's words are int32
tensors holding the uint32 bit patterns (`words.numpy().view(np.uint32)`
gives the JAX package's values).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..ops.aabbs import (aabbs_from_linear, extract_aabbs,
                         extract_aabbs_words)
from ..ops.geometry import div_scalar, voxel_center
from ..ops.voxelize import voxelize_hits, voxelize_mesh

__all__ = ["GridBool", "GridAabbStruct", "GridVec", "pack_bits",
           "unpack_bits", "pack_words", "unpack_words", "build_grid"]


@functools.lru_cache(maxsize=8)
def _bit_weights(device):
    """Bit j's int32 value, 2**j (bit 31 the sign, -2**31), on `device`,
    made once for each device."""
    return torch.tensor([1 << j for j in range(31)] + [-(1 << 31)],
                        dtype=torch.int32, device=device)


def pack_words(bits):
    """(..., 32) {0,1} tensor -> (...) int32 words, bit j of the word =
    bits[..., j] (the uint32 pattern, stored as int32).  Two operations
    whatever the size: distinct bits never carry, so the int32 sum of
    their values is their or."""
    return (bits * _bit_weights(bits.device)).sum(-1, dtype=torch.int32)


def unpack_words(words):
    """(...) int32 words -> (..., 32) uint8 bits."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[..., None] >> shifts) & 1).to(torch.uint8)


def pack_bits(occ_flat):
    """Dense {0,1} flat occupancy -> words, bit idx%32 of word idx/32."""
    n = occ_flat.shape[0]
    n_words = -(-n // 32)
    padded = torch.zeros(n_words * 32, dtype=torch.uint8,
                         device=occ_flat.device)
    padded[:n] = occ_flat.to(torch.uint8)
    return pack_words(padded.reshape(n_words, 32))


def unpack_bits(words, n_cells):
    """Words -> flat {0,1} uint8 occupancy of length n_cells."""
    return unpack_words(words).reshape(-1)[:n_cells]


def _check_bounds(x, y, z, dims):
    nx, ny, nz = dims
    if np.any(np.asarray(x) >= nx) or np.any(np.asarray(y) >= ny) \
            or np.any(np.asarray(z) >= nz) \
            or np.any(np.asarray(x) < 0) or np.any(np.asarray(y) < 0) \
            or np.any(np.asarray(z) < 0):
        raise IndexError("Index out of bounds")  # voxelgrid.hpp:68-70


def _dims_of(occ):
    return (int(occ.shape[2]), int(occ.shape[1]), int(occ.shape[0]))


@dataclass(frozen=True)
class GridBool:
    """Bitmask encoding, the one the reference app uses
    (hello_vulkan.cpp:677)."""

    words: Any                      # int32[ceil(X*Y*Z/32)] (uint32 bits)
    origin: np.ndarray              # float32[3], host
    dims: tuple                     # (X, Y, Z)
    voxel_size: float
    set_calls: int = 0              # m_voxelSet incl. duplicates

    @classmethod
    def from_occupancy(cls, occ, origin, voxel_size, set_calls=0):
        """occ: (Z, Y, X) {0,1} tensor; the words live on occ's device."""
        return cls(words=pack_bits(occ.reshape(-1)),
                   origin=np.asarray(origin, np.float32).copy(),
                   dims=_dims_of(occ), voxel_size=float(voxel_size),
                   set_calls=int(set_calls))

    @classmethod
    def from_mesh(cls, vertices, faces, voxel_size, *, device=None, **kw):
        """Voxelize a numpy mesh on `device`: by default the CUDA card
        (the K1 kernel); device="cpu" runs the plain version."""
        r = voxelize_mesh(vertices, faces, voxel_size, device=device, **kw)
        return cls.from_occupancy(r["occ"], r["origin"], r["voxel_size"],
                                  r["set_calls"])

    @property
    def n_cells(self):
        nx, ny, nz = self.dims
        return nx * ny * nz

    def occupancy(self):
        """(Z, Y, X) uint8 occupancy on the words' device."""
        nx, ny, nz = self.dims
        return unpack_bits(self.words, self.n_cells).reshape(nz, ny, nx)

    def get_voxel(self, x, y, z):
        _check_bounds(x, y, z, self.dims)
        nx, ny, _ = self.dims
        idx = int(x) + nx * (int(y) + ny * int(z))
        w = int(self.words[idx // 32]) & 0xFFFFFFFF
        return bool((w >> (idx % 32)) & 1)

    def get_coords(self, x, y, z):
        _check_bounds(x, y, z, self.dims)
        return voxel_center(x, y, z, self.origin, self.voxel_size)

    def get_aabbs(self):
        """(N, 6) float32 AABBs in ascending linear index order
        (voxelgridBool.cpp:18-52), on the words' device; one sync for N
        (ops/aabbs.extract_aabbs)."""
        return extract_aabbs(self)

    def get_aabbs_fixed(self, capacity, word_capacity=None,
                        byte_capacity=None, group_capacity=None):
        """((capacity, 6), count) from the packed words, without a host
        sync (ops/aabbs.extract_aabbs_words: rows past count zero, count
        the full popcount; the optional bounds drop the tail)."""
        return extract_aabbs_words(
            self.words, self.origin, capacity=capacity, dims=self.dims,
            voxel_size=self.voxel_size, word_capacity=word_capacity,
            byte_capacity=byte_capacity, group_capacity=group_capacity)

    def memory_usage_bytes(self):
        # m_voxel.size() * sizeof(unsigned int)
        return int(self.words.shape[0]) * 4


@dataclass(frozen=True)
class GridAabbStruct:
    """Dense AabbInternal encoding: world min/max precomputed per cell."""

    minimum: Any                    # float32[N, 3]
    maximum: Any                    # float32[N, 3]
    used: Any                       # bool[N]
    origin: np.ndarray              # float32[3], host
    dims: tuple
    voxel_size: float
    set_calls: int = 0

    @classmethod
    def from_occupancy(cls, occ, origin, voxel_size, set_calls=0):
        """occ: (Z, Y, X) {0,1} tensor; the arrays live on its device."""
        dims = _dims_of(occ)
        used = occ.reshape(-1) != 0
        lin = torch.arange(used.shape[0], device=used.device)
        boxes = aabbs_from_linear(lin, dims, origin, voxel_size)
        # unset cells hold zero-initialised AABBs (AabbInternal default)
        boxes = torch.where(used[:, None], boxes, torch.zeros_like(boxes))
        return cls(minimum=boxes[:, 0:3].contiguous(),
                   maximum=boxes[:, 3:6].contiguous(), used=used,
                   origin=np.asarray(origin, np.float32).copy(), dims=dims,
                   voxel_size=float(voxel_size), set_calls=int(set_calls))

    @classmethod
    def from_mesh(cls, vertices, faces, voxel_size, *, device=None, **kw):
        r = voxelize_mesh(vertices, faces, voxel_size, device=device, **kw)
        return cls.from_occupancy(r["occ"], r["origin"], r["voxel_size"],
                                  r["set_calls"])

    def occupancy(self):
        nx, ny, nz = self.dims
        return self.used.reshape(nz, ny, nx).to(torch.uint8)

    def get_voxel(self, x, y, z):
        _check_bounds(x, y, z, self.dims)
        nx, ny, _ = self.dims
        idx = int(x) + nx * (int(y) + ny * int(z))
        return (self.minimum[idx].cpu().numpy(),
                self.maximum[idx].cpu().numpy(), bool(self.used[idx]))

    def get_aabbs(self):
        """The used cells' boxes in linear order
        (voxelgridAABBstruct.cpp:10-23)."""
        lin = torch.nonzero(self.used).reshape(-1)
        return torch.cat([self.minimum[lin], self.maximum[lin]], dim=1)

    def memory_usage_bytes(self):
        # m_voxel.size() * sizeof(AabbInternal); the C++ struct is
        # 2 x vec3 + padded bool = 28 bytes
        nx, ny, nz = self.dims
        return nx * ny * nz * 28


@dataclass(frozen=True)
class GridVec:
    """Append-only AABB vector: duplicates kept in call order.

    The reference's setVoxel pushes a world AABB per call with no dedup
    (voxelgridVecEncoding.cpp:20-39), so a cell hit by k triangles
    appears k times.  The serial call order is triangle order, then z
    outer, y, x inner within each triangle's window: the order of
    ops/voxelize.voxelize_hits.
    """

    aabbs: Any                      # float32[M, 6] (M counts duplicates)
    origin: np.ndarray              # float32[3], host
    dims: tuple
    voxel_size: float
    set_calls: int = 0

    @classmethod
    def from_mesh(cls, vertices, faces, voxel_size, *, device=None, **kw):
        """One AABB per SAT hit of the mesh on `device` (default: the
        card), in serial emission order."""
        r = voxelize_hits(vertices, faces, voxel_size, device=device, **kw)
        boxes = aabbs_from_linear(r["lin"], r["dims"], r["origin"],
                                  voxel_size)
        return cls(aabbs=boxes, origin=r["origin"], dims=r["dims"],
                   voxel_size=float(voxel_size), set_calls=r["set_calls"])

    def get_aabbs(self):
        return self.aabbs  # verbatim (voxelgridVecEncoding.cpp:16-19)

    def cells(self):
        """Each box's cell as an int64 linear index, in list order: the
        floor of each box centre's grid coordinates."""
        nx, ny, _ = self.dims
        half = float(np.float32(self.voxel_size * 0.5))
        centers = self.aabbs[:, 0:3] + half
        org = torch.as_tensor(self.origin, device=self.aabbs.device)
        idx = div_scalar(centers - org,
                         float(np.float32(self.voxel_size))).to(torch.int64)
        return idx[:, 0] + nx * (idx[:, 1] + ny * idx[:, 2])

    def occupancy(self):
        """(Z, Y, X) uint8 occupancy of the boxes' cells."""
        nx, ny, nz = self.dims
        dev = self.aabbs.device
        occ = torch.zeros(nz * ny * nx, dtype=torch.uint8, device=dev)
        if self.aabbs.shape[0]:
            occ[self.cells()] = 1
        return occ.reshape(nz, ny, nx)

    def memory_usage_bytes(self):
        # m_voxel.size() * sizeof(Aabb) = 24 bytes per entry
        return int(self.aabbs.shape[0]) * 24


def build_grid(encoding: str, vertices, faces, voxel_size, **kw):
    """Encoding-dispatch constructor: 'bool' | 'aabbstruct' | 'vec' |
    'octree'.  Runs on the CUDA card unless `device=` says otherwise."""
    if encoding == "bool":
        return GridBool.from_mesh(vertices, faces, voxel_size, **kw)
    if encoding == "aabbstruct":
        return GridAabbStruct.from_mesh(vertices, faces, voxel_size, **kw)
    if encoding == "vec":
        return GridVec.from_mesh(vertices, faces, voxel_size, **kw)
    if encoding == "octree":
        from .octree import Octree
        return Octree.from_mesh(vertices, faces, voxel_size, **kw)
    raise ValueError(f"unknown encoding '{encoding}'")
