"""Mesh voxelization: per-triangle clamped windows + the 13-axis SAT.

The reference voxelizes on the CPU: per triangle, a clamped voxel window
is scanned with a triple loop and a SAT test per cell
(VoxelBuilder.hpp:164-196).  `voxelize_mesh` is the entry point; it sends
CUDA tensors to the hand-written kernel (ops/kernels/voxel_accum.py) and
CPU tensors to `voxelize_plain`, the PyTorch version of the same
function.

`voxelize_plain` enumerates every triangle's window cells as one ragged
slot list (no padding to a shared window shape, so one large triangle
does not size anyone else's window), in the `_chunk_hits` unravel order
of voxelray_tpu/ops/voxelize.py (x fastest), and processes it in chunks
of at most 2^22 slots on CUDA (2^16 on the CPU) so memory stays bounded:
each slot carries ~60 live float32 temporaries.  Occupancy and
set_calls are bit-exact against the JAX package: identical window
truncation (including the max-boundary drop quirk) and identical f32
expression shapes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .geometry import div_scalar, grid_dims, mesh_bbox
from .sat import tri_box_overlap

__all__ = ["window_bounds", "voxelize_plain", "hit_stream",
           "tri_cell_pairs", "voxelize_hits", "voxelize_mesh"]


def window_bounds(tri_min, tri_max, origin, voxel_size, dims):
    """Per-triangle clamped cell windows, the VoxelBuilder.hpp:175-184 math.

    tri_min/tri_max: (..., 3) float32 tensors.  Returns (start, end) int32
    tensors, start >= 0, end <= dims, with the reference's float divide,
    truncation toward zero and `+2` slack.
    """
    origin = torch.as_tensor(np.asarray(origin, np.float32),
                             device=tri_min.device)
    vs = float(np.float32(voxel_size))
    dims_t = torch.tensor(dims, dtype=torch.int32, device=tri_min.device)
    start = torch.clamp(div_scalar(tri_min - origin, vs).to(torch.int32),
                        min=0)
    end = torch.minimum(dims_t,
                        div_scalar(tri_max - origin, vs).to(torch.int32) + 2)
    return start, end


def _window_hits(tri, origin, voxel_size, dims):
    """SAT hits over every triangle's clamped window, chunk by chunk.

    tri: (F, 3, 3) float32.  Yields (t, lin, hit) per chunk of window
    slots: the owning triangle, the cell's linear index (int64) and the
    SAT result.  A triangle with a non-finite vertex gets an empty window.
    """
    nx, ny, nz = dims
    dev = tri.device
    if tri.shape[0] == 0 or nx * ny * nz == 0:
        return
    vs = float(np.float32(voxel_size))
    half = float(np.float32(voxel_size * 0.5))
    org = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    tmin = torch.minimum(v0, torch.minimum(v1, v2))
    tmax = torch.maximum(v0, torch.maximum(v1, v2))
    finite = torch.isfinite(tri).flatten(1).all(dim=1)
    tmin = torch.where(finite[:, None], tmin, torch.zeros_like(tmin))
    tmax = torch.where(finite[:, None], tmax, torch.full_like(tmax, -1.0))
    start, end = window_bounds(tmin, tmax, origin, voxel_size, dims)
    w = torch.clamp(end - start, min=0).long()
    w = torch.where(finite[:, None], w, torch.zeros_like(w))
    cap = w[:, 0] * w[:, 1] * w[:, 2]                   # slots per triangle
    cum = torch.cumsum(cap, 0)
    total = int(cum[-1])
    first = cum - cap                                   # first slot of each
    budget = (1 << 22) if dev.type == "cuda" else (1 << 16)
    for s0 in range(0, total, budget):
        slot = torch.arange(s0, min(s0 + budget, total), device=dev)
        t = torch.searchsorted(cum, slot, right=True)   # owning triangle
        k = slot - first[t]
        wx, wy = w[t, 0], w[t, 1]
        dx = k % wx
        dy = (k // wx) % wy
        dz = k // (wx * wy)
        cx = start[t, 0] + dx
        cy = start[t, 1] + dy
        cz = start[t, 2] + dz
        centers = torch.stack([
            org[0] + (cx.to(torch.float32) + 0.5) * vs,
            org[1] + (cy.to(torch.float32) + 0.5) * vs,
            org[2] + (cz.to(torch.float32) + 0.5) * vs,
        ], dim=-1)
        hit = tri_box_overlap(centers, half, v0[t], v1[t], v2[t])
        lin = cx.long() + nx * (cy.long() + ny * cz.long())
        yield t, lin, hit


def voxelize_plain(v, f, origin, voxel_size, dims):
    """Plain PyTorch voxelizer: (occ (Z,Y,X) uint8, set_calls int).

    v: (V, 3) float32, f: (F, 3) int32/int64, on one device; origin the
    float32 grid min corner, dims (X, Y, Z).  A triangle with a
    non-finite vertex gets an empty window.
    """
    nx, ny, nz = dims
    occ = torch.zeros(nz * ny * nx, dtype=torch.uint8, device=v.device)
    calls = torch.zeros((), dtype=torch.int64, device=v.device)
    for _, lin, hit in _window_hits(v[f.long()], origin, voxel_size, dims):
        occ[lin[hit]] = 1
        calls += hit.sum()
    return occ.reshape(nz, ny, nx), int(calls)


def hit_stream(tri, origin, voxel_size, dims):
    """Every (triangle, cell) SAT hit in serial emission order.

    The order of the reference's setVoxel calls (VoxelBuilder.hpp:
    164-196): triangle order, then z outer, y, x inner within each
    triangle's clamped window, duplicates kept: the order of
    `_window_hits`' slot list.  tri: (F, 3, 3) float32.  Returns
    (tri_id, lin) int64 tensors; their length is set_calls.
    """
    ts, lins = [], []
    for t, lin, hit in _window_hits(tri, origin, voxel_size, dims):
        ts.append(t[hit])
        lins.append(lin[hit])
    if not ts:
        empty = torch.zeros((0,), dtype=torch.int64, device=tri.device)
        return empty, empty.clone()
    return torch.cat(ts), torch.cat(lins)


def tri_cell_pairs(tri, origin, voxel_size, dims):
    """Every (triangle, cell) SAT hit inside the triangle's clamped window.

    The pair listing the triangle accel is built from: the JAX package
    gets the same set from plan_buckets + voxelize_dense(with_hit_mask)
    (voxelray_tpu/ops/tri_accel.py:95-121).  tri: (F, 3, 3) float32.
    Returns (tri_id, lin) int64 tensors sorted by (lin, tri_id).
    """
    t, lin = hit_stream(tri, origin, voxel_size, dims)
    # a triangle lists each cell of its window once, so the keys are unique
    order = torch.argsort(lin * tri.shape[0] + t)
    return t[order], lin[order]


def _mesh_grid(vertices, faces, voxel_size, bb_min, bb_max):
    """Host-side mesh arrays, grid origin and dims (the reference's math;
    a mesh without vertices gets an empty grid at the origin)."""
    v = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    f = np.asarray(faces).reshape(-1, 3)
    if not len(v):
        return v, f, np.zeros(3, np.float32), (0, 0, 0)
    if bb_min is None or bb_max is None:
        bb_min, bb_max = mesh_bbox(v)
    bb_min = np.asarray(bb_min, dtype=np.float32)
    bb_max = np.asarray(bb_max, dtype=np.float32)
    return v, f, bb_min, grid_dims(bb_min, bb_max, voxel_size)


def voxelize_hits(vertices, faces, voxel_size, *, bb_min=None, bb_max=None,
                  device=None):
    """The hit stream of a numpy mesh on `device` (default: the card).

    Counterpart of voxelize_dense(with_hit_mask=True)
    (voxelray_tpu/ops/voxelize.py:267) as GridVec.from_mesh and
    Octree.from_mesh read it.  Returns a dict with tri and lin (int64,
    serial emission order, see hit_stream), set_calls, dims, origin and
    voxel_size.
    """
    device = resolve_device(device)
    v, f, origin, dims = _mesh_grid(vertices, faces, voxel_size, bb_min,
                                    bb_max)
    out = {"dims": dims, "origin": origin, "voxel_size": float(voxel_size)}
    if 0 in dims or not len(f):
        empty = torch.zeros((0,), dtype=torch.int64, device=device)
        return {**out, "tri": empty, "lin": empty.clone(), "set_calls": 0}
    tri = torch.as_tensor(v[f.astype(np.int64)], device=device)
    t, lin = hit_stream(tri, origin, voxel_size, dims)
    return {**out, "tri": t, "lin": lin, "set_calls": int(lin.shape[0])}


def voxelize_mesh(vertices, faces, voxel_size, *, bb_min=None, bb_max=None,
                  device=None):
    """Host-facing wrapper: mesh in, occupancy + grid metadata out.

    Computes bbox/dims host-side (exact reference math), then runs the
    voxelizer on `device` (default: the CUDA card, utils/device.py).
    Returns a dict with occ (Z,Y,X) uint8 on the device plus
    dims/origin/voxel_size/set_calls.
    """
    from .kernels.voxel_accum import voxel_accum

    device = resolve_device(device)

    v = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    f = np.asarray(faces).reshape(-1, 3)
    if len(v) == 0 or len(f) == 0:
        return {"occ": torch.zeros((0, 0, 0), dtype=torch.uint8,
                                   device=device),
                "dims": (0, 0, 0), "origin": np.zeros(3, np.float32),
                "voxel_size": float(voxel_size), "set_calls": 0}
    if bb_min is None or bb_max is None:
        bb_min, bb_max = mesh_bbox(v)
    bb_min = np.asarray(bb_min, dtype=np.float32)
    bb_max = np.asarray(bb_max, dtype=np.float32)
    dims = grid_dims(bb_min, bb_max, voxel_size)
    nx, ny, nz = dims
    if nx == 0 or ny == 0 or nz == 0:
        return {"occ": torch.zeros((nz, ny, nx), dtype=torch.uint8,
                                   device=device),
                "dims": dims, "origin": bb_min,
                "voxel_size": float(voxel_size), "set_calls": 0}
    v_t = torch.as_tensor(v, device=device)
    f_t = torch.as_tensor(f.astype(np.int32), device=device)
    occ, calls = voxel_accum(v_t, f_t, bb_min, voxel_size, dims)
    return {"occ": occ, "dims": dims, "origin": bb_min,
            "voxel_size": float(voxel_size), "set_calls": int(calls)}
