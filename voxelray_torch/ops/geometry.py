"""Grid geometry math: bounding boxes, grid dimensioning, index maps.

Host-side numpy float32, exactly as voxelray_tpu/ops/geometry.py, so the
grid a mesh maps to is bit-identical in both packages:
  - index map x + X*(y + Y*z)            (reference: src/voxelgrid.hpp:37-40)
  - inverse map                          (reference: src/voxelgrid.hpp:42-49)
  - voxel center org + (pos+0.5)*size    (reference: src/voxelgrid.hpp:91-100)
  - dims = ceil(extent / voxelSize)      (reference: src/VoxelBuilder.hpp:347-349)
  - mesh bbox over *all* vertices, not only referenced ones
                                         (reference: src/VoxelBuilder.hpp:198-224)
The index maps also work elementwise on integer tensors.  `div_scalar`
is the float32 division by a constant that the port's tensor code uses.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["mesh_bbox", "grid_dims", "map3d_to_1d", "map1d_to_3d",
           "voxel_center", "div_scalar", "floor_cell", "voxel_diameter"]


def div_scalar(x, s):
    """x / s, rounded as one IEEE float32 division on every device.

    PyTorch's CUDA kernel for division by a Python scalar multiplies by
    the scalar's reciprocal, which can be one ulp off the quotient and
    then moves a truncated window bound or a floored cell index.  A 0-dim
    divisor tensor on x's device takes the true-division path.
    """
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def floor_cell(x):
    """floor(x) as int32 cell indices, NaN -> 0, clamped to +-2^30.

    The walks floor float positions into cell indices and clamp them;
    C's float-to-int conversion of NaN or of an out-of-range value is
    undefined and differs between the CPU and the card, so the kernels
    and their plain versions both convert through this rule.
    """
    f = torch.clamp(torch.floor(x), -2.0 ** 30, 2.0 ** 30)
    return torch.nan_to_num(f, nan=0.0).to(torch.int32)


def mesh_bbox(vertices) -> tuple[np.ndarray, np.ndarray]:
    """(min, max) corners over every vertex row, float32.

    Empty input yields (+inf, -inf) corners exactly like the C++ loop.
    """
    v = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    if v.shape[0] == 0:
        return (
            np.full(3, np.inf, dtype=np.float32),
            np.full(3, -np.inf, dtype=np.float32),
        )
    return v.min(axis=0), v.max(axis=0)


def grid_dims(bb_min, bb_max, voxel_size: float) -> tuple[int, int, int]:
    """Per-axis cell counts: ceil((max-min)/voxelSize) evaluated in float32.

    A degenerate axis (zero extent) yields 0 cells, as in the reference.
    """
    bb_min = np.asarray(bb_min, dtype=np.float32)
    bb_max = np.asarray(bb_max, dtype=np.float32)
    vs = np.float32(voxel_size)
    ext = (bb_max - bb_min) / vs
    dims = np.ceil(ext).astype(np.int64)
    return int(dims[0]), int(dims[1]), int(dims[2])


def map3d_to_1d(x, y, z, dims):
    """Linear voxel index x + X*(y + Y*z); x is the fastest-varying axis."""
    nx, ny, _ = dims
    return x + nx * (y + ny * z)


def map1d_to_3d(i, dims):
    """Inverse of map3d_to_1d; returns (x, y, z)."""
    nx, ny, _ = dims
    x = i % nx
    y = (i // nx) % ny
    z = i // (nx * ny)
    return x, y, z


def voxel_center(x, y, z, origin, voxel_size):
    """World-space cell center: origin + (idx + 0.5) * voxelSize, float32.

    The (idx + 0.5) sum happens before the multiply, exactly as in
    voxelgrid.hpp:91-100, so the float rounding sequence is identical.
    """
    origin = np.asarray(origin, dtype=np.float32)
    vs = np.float32(voxel_size)
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    z = np.asarray(z, dtype=np.float32)
    return np.stack(
        [
            origin[0] + (x + np.float32(0.5)) * vs,
            origin[1] + (y + np.float32(0.5)) * vs,
            origin[2] + (z + np.float32(0.5)) * vs,
        ],
        axis=-1,
    )


def voxel_diameter(voxel_size: float) -> float:
    """hypot(s, s, s) — the cell's space diagonal (voxelgrid.hpp:58-62)."""
    s = np.float32(voxel_size)
    return float(np.sqrt(s * s + s * s + s * s))
