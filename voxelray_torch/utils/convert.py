"""Carry state from the JAX package (as numpy arrays) into the port.

The JAX package stores bit words as uint32; the port stores the same bit
patterns in int32 tensors.  Convert with numpy arrays only, so neither
package imports the other: the four grid encodings, a BrickAccel, a
TriAccel and a Scene's arrays, so tests can feed both packages the same
state.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.grids import GridAabbStruct, GridBool, GridVec
from ..models.octree import INVALID_INDEX, Octree
from ..models.scene import Scene
from ..ops.traverse_fast import BrickAccel
from ..ops.tri_accel import TriAccel

__all__ = ["grid_from_numpy", "aabbstruct_from_numpy", "gridvec_from_numpy",
           "octree_from_numpy", "accel_from_numpy", "tri_accel_from_numpy",
           "scene_from_numpy", "words_to_tensor", "SCENE_ARRAYS"]

# the Scene fields that are plain arrays, as the JAX Scene names them
SCENE_ARRAYS = ("tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
                "tri_uv0", "tri_uv1", "tri_uv2", "tri_mat", "tri_tex",
                "tri_lod", "materials", "textures", "tex_meta",
                "voxel_aabbs", "voxel_material", "occ_flat", "grid_origin")


def words_to_tensor(words, device="cpu"):
    """uint32 (or int32) numpy words -> int32 tensor of the same bits."""
    w = np.ascontiguousarray(np.asarray(words))
    if w.dtype not in (np.uint32, np.int32):
        raise ValueError(f"bit words must be uint32 or int32, got {w.dtype}")
    return torch.from_numpy(w.view(np.int32).copy()).to(device)


def grid_from_numpy(occ, origin, voxel_size, set_calls=0, device="cpu"):
    """(Z, Y, X) {0,1} occupancy array -> port GridBool on `device`."""
    occ_t = torch.as_tensor(np.array(occ, np.uint8), device=device)
    return GridBool.from_occupancy(occ_t, np.asarray(origin, np.float32),
                                   float(voxel_size), int(set_calls))


def aabbstruct_from_numpy(minimum, maximum, used, origin, dims, voxel_size,
                          set_calls=0, device="cpu") -> GridAabbStruct:
    """The JAX GridAabbStruct's arrays -> port GridAabbStruct."""
    return GridAabbStruct(
        minimum=torch.as_tensor(np.array(minimum, np.float32), device=device),
        maximum=torch.as_tensor(np.array(maximum, np.float32), device=device),
        used=torch.as_tensor(np.array(used, bool), device=device),
        origin=np.array(origin, np.float32),
        dims=tuple(int(x) for x in dims), voxel_size=float(voxel_size),
        set_calls=int(set_calls))


def gridvec_from_numpy(aabbs, origin, dims, voxel_size, set_calls=0,
                       device="cpu") -> GridVec:
    """The JAX GridVec's list -> port GridVec."""
    return GridVec(
        aabbs=torch.as_tensor(np.array(aabbs, np.float32), device=device),
        origin=np.array(origin, np.float32),
        dims=tuple(int(x) for x in dims), voxel_size=float(voxel_size),
        set_calls=int(set_calls))


def octree_from_numpy(code_hi, code_lo, children, node_start, node_count,
                      root_min, dims, voxel_size, bits_per_axis, max_items,
                      set_calls=0, device="cpu") -> Octree:
    """The JAX Octree's arrays (uint32 code limbs, children with -1 for
    INVALID) -> port Octree, its region map and item rows rebuilt as the
    JAX package builds them."""
    codes = ((np.asarray(code_hi).astype(np.uint64) << np.uint64(32))
             | np.asarray(code_lo).astype(np.uint64))
    ch = np.asarray(children).astype(np.int64)
    nodes = np.concatenate(
        [np.where(ch < 0, np.int64(INVALID_INDEX), ch),
         np.asarray(node_start).astype(np.int64)[:, None],
         np.asarray(node_count).astype(np.int64)[:, None]], axis=1)
    return Octree.from_arrays(
        torch.as_tensor(codes.astype(np.int64), device=device), nodes,
        root_min, dims, voxel_size, bits_per_axis, max_items, set_calls,
        device)


def accel_from_numpy(coarse, fine, l2, fine_sb, origin, dims, bdims,
                     voxel_size, device="cpu", fine_off=0) -> BrickAccel:
    """The JAX BrickAccel's tables (numpy uint32) -> port BrickAccel;
    fine_off: a slab accel's first brick id in `fine`."""
    org = np.asarray(origin, np.float32)
    return BrickAccel(
        coarse=words_to_tensor(coarse, device),
        fine=words_to_tensor(fine, device),
        l2=words_to_tensor(l2, device),
        origin=torch.as_tensor(org.copy(), device=device),
        dims=tuple(int(x) for x in dims),
        bdims=tuple(int(x) for x in bdims),
        voxel_size=float(voxel_size),
        origin_key=(float(org[0]), float(org[1]), float(org[2])),
        fine_sb=None if fine_sb is None else words_to_tensor(fine_sb,
                                                             device),
        fine_off=int(fine_off))


def tri_accel_from_numpy(brick: BrickAccel, cell_slot, cell_tris, tri9,
                         origin, dims, voxel_size, l_width, overflow_cells,
                         device="cpu") -> TriAccel:
    """The JAX TriAccel's tables (numpy) -> port TriAccel; `brick` is its
    BrickAccel already carried over with accel_from_numpy."""
    def as_t(x, dtype):
        return torch.as_tensor(np.array(x, dtype), device=device)
    return TriAccel(
        brick=brick, cell_slot=as_t(cell_slot, np.int32),
        cell_tris=as_t(cell_tris, np.int32), tri9=as_t(tri9, np.float32),
        origin=as_t(origin, np.float32),
        dims=tuple(int(x) for x in dims), voxel_size=float(voxel_size),
        l_width=int(l_width), overflow_cells=int(overflow_cells))


def scene_from_numpy(arrays, grid_dims, grid_voxel_size, accel=None,
                     tri_accel=None, octree=None, device="cpu") -> Scene:
    """A JAX Scene's arrays (a mapping with the SCENE_ARRAYS names, numpy)
    plus its accels and octree (already carried over) -> port Scene."""
    return Scene(
        **{k: torch.as_tensor(np.array(arrays[k]), device=device)
           for k in SCENE_ARRAYS},
        accel=accel, octree=octree, tri_accel=tri_accel,
        grid_dims=tuple(int(x) for x in grid_dims),
        grid_voxel_size=float(grid_voxel_size))
