"""Grid / octree persistence as .npz: build once, render many times.

Counterpart of voxelray_tpu/utils/checkpoint.py, in the same file format,
so a file written by either package loads in the other: one .npz with a
`__meta__` entry (the repr of a dict: kind, dims, voxel_size, set_calls
and the octree's bits_per_axis, max_items, origin_key) and the arrays
under the JAX package's field names, GridBool's words as uint32 and the
octree's codes as code_hi / code_lo uint32 limbs.  The octree's region
map and item rows are derived state, rebuilt on load.
"""
from __future__ import annotations

import ast

import numpy as np
import torch

from ..models.grids import GridAabbStruct, GridBool, GridVec
from ..models.octree import Octree
from .convert import octree_from_numpy
from .device import resolve_device

__all__ = ["save_grid", "load_grid"]

_KINDS = {"GridBool": GridBool, "GridAabbStruct": GridAabbStruct,
          "GridVec": GridVec, "Octree": Octree}


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _grid_meta(grid):
    return dict(dims=tuple(int(x) for x in grid.dims),
                voxel_size=float(grid.voxel_size),
                set_calls=int(grid.set_calls))


def save_grid(path, grid) -> None:
    kind = type(grid).__name__
    if kind not in _KINDS:
        raise TypeError(f"cannot checkpoint {kind}")
    meta = {"kind": kind}
    if kind == "Octree":
        codes = grid.codes_u64()
        arrays = {"code_hi": (codes >> np.uint64(32)).astype(np.uint32),
                  "code_lo": (codes & np.uint64(0xFFFFFFFF)).astype(
                      np.uint32),
                  "item_x": _np(grid.item_x), "item_y": _np(grid.item_y),
                  "item_z": _np(grid.item_z),
                  "children": _np(grid.children),
                  "node_start": _np(grid.node_start),
                  "node_count": _np(grid.node_count),
                  "root_min": _np(grid.root_min)}
        meta.update(_grid_meta(grid), bits_per_axis=int(grid.bits_per_axis),
                    max_items=int(grid.max_items),
                    origin_key=tuple(float(x) for x in grid.origin_key))
    else:
        meta.update(_grid_meta(grid))
        arrays = {"origin": _np(grid.origin)}
        if kind == "GridBool":
            arrays["words"] = _np(grid.words).view(np.uint32)
        elif kind == "GridAabbStruct":
            arrays.update(minimum=_np(grid.minimum),
                          maximum=_np(grid.maximum), used=_np(grid.used))
        else:
            arrays["aabbs"] = _np(grid.aabbs)
    np.savez_compressed(path, __meta__=np.asarray([repr(meta)]), **arrays)


def load_grid(path, device=None):
    """The grid saved at `path`, on `device` (default: the CUDA card)."""
    dev = resolve_device(device)
    data = np.load(path, allow_pickle=False)
    meta = ast.literal_eval(str(data["__meta__"][0]))
    kind = meta.pop("kind")
    arrays = {k: data[k] for k in data.files if k != "__meta__"}
    dims = tuple(int(x) for x in meta["dims"])

    def t(name):
        return torch.as_tensor(arrays[name], device=dev)

    if kind == "Octree":
        return octree_from_numpy(
            arrays["code_hi"], arrays["code_lo"], arrays["children"],
            arrays["node_start"], arrays["node_count"], arrays["root_min"],
            dims, meta["voxel_size"], meta["bits_per_axis"],
            meta["max_items"], meta["set_calls"], device=dev)
    common = dict(origin=np.asarray(arrays["origin"], np.float32), dims=dims,
                  voxel_size=float(meta["voxel_size"]),
                  set_calls=int(meta["set_calls"]))
    if kind == "GridBool":
        return GridBool(words=torch.as_tensor(
            arrays["words"].view(np.int32), device=dev), **common)
    if kind == "GridAabbStruct":
        return GridAabbStruct(minimum=t("minimum"), maximum=t("maximum"),
                              used=t("used").to(torch.bool), **common)
    return GridVec(aabbs=t("aabbs"), **common)
