"""Batch-of-frames voxelization (BASELINE config 5) on one device.

Counterpart of `voxelize_frames_sharded` in voxelray_tpu/parallel/comm.py
(:91), which shards the frames of a deforming mesh over a device mesh,
each device voxelizing whole frames with no collective.  On one card the
frames run one after another, one voxelize launch (kernel K1) per frame
on CUDA tensors, the plain voxelizer on the CPU.  The JAX version's
`window` and `chunk` arguments size its static tile plan; the port's
voxelizer sizes each triangle's window itself, so they are not taken.

The multi-device paths of that module (`voxelize_sharded`,
`render_sharded`, `render_zslab_sharded`) are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels.voxel_accum import voxel_accum
from ..utils.device import resolve_device

__all__ = ["voxelize_frames_sharded"]


def voxelize_frames_sharded(frame_verts, faces, origin, *, dims,
                            voxel_size, device=None):
    """Voxelize each frame of a fixed-topology mesh into one grid.

    frame_verts: (F, V, 3) float32, one deformed vertex set per
    animation frame; faces (T, 3); origin (3,) float32 grid min corner;
    dims (X, Y, Z).  Runs on `device` (default: the CUDA card).  Returns
    (occ (F, Z, Y, X) uint8, set_calls (F,) int64) on the device.
    """
    dev = resolve_device(device)
    fv = np.asarray(frame_verts, np.float32)
    f = torch.as_tensor(np.asarray(faces).reshape(-1, 3).astype(np.int32),
                        device=dev)
    nx, ny, nz = (int(x) for x in dims)
    occ = torch.zeros((fv.shape[0], nz, ny, nx), dtype=torch.uint8,
                      device=dev)
    calls = torch.zeros((fv.shape[0],), dtype=torch.int64, device=dev)
    for i in range(fv.shape[0]):
        v = torch.as_tensor(np.ascontiguousarray(fv[i]), device=dev)
        occ[i], calls[i] = voxel_accum(v, f, origin, voxel_size,
                                       (nx, ny, nz))
    return occ, calls
