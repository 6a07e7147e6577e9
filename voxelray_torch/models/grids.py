"""GridBool, the 1-bit-per-cell voxel grid, on torch tensors.

Counterpart of voxelray_tpu/models/grids.py GridBool, which mirrors the
reference's VoxelGridBool (src/voxelgridBool.{hpp,cpp}): occupancy packed
into 32-bit words, word = idx/32, bit = idx%32, linear index
x + X*(y + Y*z), and a set_calls counter that counts SAT hits (setVoxel
calls, duplicates included).

PyTorch has no general uint32 arithmetic, so words are int32 tensors
holding the uint32 bit patterns (`words.numpy().view(np.uint32)` gives
the JAX package's values).  The AABB extraction and the other encodings
come with later slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..ops.voxelize import voxelize_mesh

__all__ = ["GridBool", "pack_bits", "unpack_bits", "pack_words",
           "unpack_words", "build_grid"]


def pack_words(bits):
    """(..., 32) {0,1} tensor -> (...) int32 words, bit j of the word =
    bits[..., j] (the uint32 pattern, stored as int32)."""
    acc = torch.zeros(bits.shape[:-1], dtype=torch.int64, device=bits.device)
    for j in range(32):
        acc |= bits[..., j].to(torch.int64) << j
    return torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32)


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


def _later(what):
    raise NotImplementedError(
        f"GridBool.{what} is not ported yet: it comes with the AABB "
        "extraction slice; see ROADMAP.md")


@dataclass(frozen=True)
class GridBool:
    """Bitmask encoding — the one the reference app actually uses
    (hello_vulkan.cpp:677)."""

    words: Any                      # int32[ceil(X*Y*Z/32)] (uint32 bits)
    origin: np.ndarray              # float32[3], host
    dims: tuple                     # (X, Y, Z)
    voxel_size: float
    set_calls: int = 0              # m_voxelSet incl. duplicates

    @classmethod
    def from_occupancy(cls, occ, origin, voxel_size, set_calls=0):
        """occ: (Z, Y, X) {0,1} tensor; the words live on occ's device."""
        dims = (int(occ.shape[2]), int(occ.shape[1]), int(occ.shape[0]))
        return cls(words=pack_bits(occ.reshape(-1)),
                   origin=np.asarray(origin, np.float32).copy(),
                   dims=dims, voxel_size=float(voxel_size),
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

    def memory_usage_bytes(self):
        # m_voxel.size() * sizeof(unsigned int)
        return int(self.words.shape[0]) * 4

    def get_aabbs(self):
        _later("get_aabbs")

    def get_aabbs_fixed(self, *args, **kw):
        _later("get_aabbs_fixed")


def build_grid(encoding: str, vertices, faces, voxel_size, **kw):
    """Encoding-dispatch constructor; only 'bool' is ported so far.
    Runs on the CUDA card unless `device=` says otherwise."""
    if encoding == "bool":
        return GridBool.from_mesh(vertices, faces, voxel_size, **kw)
    if encoding in ("aabbstruct", "vec"):
        raise NotImplementedError(
            f"encoding '{encoding}' is not ported yet: it comes with the "
            "other-encodings slice; see ROADMAP.md")
    if encoding == "octree":
        raise NotImplementedError(
            "encoding 'octree' is not ported yet: it comes with the octree "
            "slice; see ROADMAP.md")
    raise ValueError(f"unknown encoding '{encoding}'")
