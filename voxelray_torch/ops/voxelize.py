"""Mesh voxelization: per-triangle clamped windows + the 13-axis SAT.

The reference voxelizes on the CPU: per triangle, a clamped voxel window
is scanned with a triple loop and a SAT test per cell
(VoxelBuilder.hpp:164-196).  `voxelize_mesh` is the entry point; it sends
CUDA tensors to the hand-written kernel (ops/kernels/voxel_accum.py) and
CPU tensors to `voxelize_plain`, the PyTorch version of the same
function.

`VoxelizePlan` / `voxelize_planned` are the planned voxelize for a mesh
whose topology stays fixed (a deforming mesh, repeated frames): the grid
and the faces go to the device once, and each call is one K1 launch with
no host sync.

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

from ..utils import trace
from ..utils.device import resolve_device
from .geometry import div_scalar, grid_dims, mesh_bbox
from .sat import tri_box_overlap

__all__ = ["window_bounds", "voxelize_plain", "hit_stream",
           "tri_cell_pairs", "voxelize_hits", "voxelize_mesh",
           "required_window_shape", "plan_buckets", "VoxelizePlan",
           "plan_voxelize", "voxelize_planned"]


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


@trace.spanned("voxelize_mesh")
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


def _np_windows(vertices, faces, origin, voxel_size, dims):
    """Host-side per-triangle (start, end) with the exact reference math."""
    v = np.asarray(vertices, dtype=np.float32)
    f = np.asarray(faces)
    tri = v[f]
    tmin = tri.min(axis=1)
    tmax = tri.max(axis=1)
    origin = np.asarray(origin, dtype=np.float32)
    vs = np.float32(voxel_size)
    dims_arr = np.asarray(dims, dtype=np.int32)
    start = np.maximum(0, ((tmin - origin) / vs).astype(np.int32))
    end = np.minimum(dims_arr, ((tmax - origin) / vs).astype(np.int32) + 2)
    return start, np.maximum(end, start)


def _np_effective_extents(vertices, faces, origin, voxel_size, dims):
    """Per-triangle tested-window extents with provably-dead slabs cut.

    The reference's window end is trunc(max/vs)+2 (VoxelBuilder.hpp:
    175-184): for a triangle whose max is strictly inside cell t, the
    final slab t+1 can never pass the SAT's box-axis test (separation
    there is `tmax - center < -half`), so skipping it changes neither
    occupancy nor set_calls.  Slabs are cut only where separation holds
    by a 16-ulp margin; borderline triangles keep the full reference
    window.  A copy of voxelray_tpu/ops/voxelize.py's.

    Returns (start, w_eff): int32 (F, 3) arrays, w_eff >= 1.
    """
    start, end = _np_windows(vertices, faces, origin, voxel_size, dims)
    v = np.asarray(vertices, np.float32)
    tmax = v[np.asarray(faces)].max(axis=1).astype(np.float32)
    w_eff = np.maximum(end - start, 1).astype(np.int32)
    origin = np.asarray(origin, np.float32)
    vs = np.float32(voxel_size)
    h = np.float32(voxel_size * 0.5)
    eps = np.float32(2 ** -23)
    for ax in range(3):
        for _ in range(2):   # reference slack is at most 2 slabs
            last = (start[:, ax] + w_eff[:, ax] - 1).astype(np.float32)
            c = (origin[ax] + (last + np.float32(0.5)) * vs) \
                .astype(np.float32)
            t = (tmax[:, ax] - c).astype(np.float32)
            margin = 16 * eps * np.maximum(
                np.maximum(np.abs(c), np.abs(tmax[:, ax])), vs)
            sep = (t < -h - margin) & (w_eff[:, ax] > 1)
            if not sep.any():
                break
            w_eff[sep, ax] -= 1
    return start, w_eff


def required_window_shape(vertices, faces, origin, voxel_size, dims):
    """Max per-axis window extent over all triangles (host-side numpy),
    as voxelray_tpu/ops/voxelize.py computes it."""
    f = np.asarray(faces)
    if len(f) == 0:
        return (1, 1, 1)
    start, end = _np_windows(vertices, faces, origin, voxel_size, dims)
    w = (end - start).max(axis=0)
    return (max(1, int(w[0])), max(1, int(w[1])), max(1, int(w[2])))


def plan_buckets(vertices, faces, origin, voxel_size, dims,
                 max_buckets: int = 6, effective: bool = True):
    """Group triangles by exact per-axis window extents, as
    voxelray_tpu/ops/voxelize.py does: [(window_shape, tri_indices), ...].

    Greedy merge: the smallest group is absorbed into the group whose
    elementwise-max shape wastes the least slot volume, until at most
    max_buckets remain.  effective=True buckets by the extents with dead
    final slabs cut (proven for these vertices only); effective=False by
    the full reference windows, the shape a plan must use when it runs
    against deformed vertices.
    """
    f = np.asarray(faces)
    if len(f) == 0:
        return []
    if effective:
        start, w = _np_effective_extents(vertices, faces, origin,
                                         voxel_size, dims)
    else:
        start, end = _np_windows(vertices, faces, origin, voxel_size,
                                 dims)
        w = np.maximum(end - start, 1).astype(np.int32)
    keys, inverse, counts = np.unique(w, axis=0, return_inverse=True,
                                      return_counts=True)
    order = np.argsort(inverse, kind="stable")
    bounds = np.cumsum(counts)[:-1]
    groups = np.split(order, bounds)  # group g = tri indices of keys[g]
    items = [(tuple(int(x) for x in keys[g]), list(groups[g]))
             for g in range(len(keys))]
    items.sort(key=lambda kv: -len(kv[1]))
    while len(items) > max_buckets:
        ka, ia = items[-1]
        best_j, best_cost, best_shape = None, None, None
        for j in range(len(items) - 1):
            kb, ib = items[j]
            merged = tuple(max(a, b) for a, b in zip(ka, kb))
            vol = merged[0] * merged[1] * merged[2]
            cost = (vol - ka[0] * ka[1] * ka[2]) * len(ia) \
                + (vol - kb[0] * kb[1] * kb[2]) * len(ib)
            if best_cost is None or cost < best_cost:
                best_j, best_cost, best_shape = j, cost, merged
        kb, ib = items[best_j]
        items[best_j] = (best_shape, ib + ia)
        items.pop()
        items.sort(key=lambda kv: -len(kv[1]))
    return [((int(k[0]), int(k[1]), int(k[2])), np.asarray(i))
            for k, i in items]


class VoxelizePlan:
    """Grid and faces of a mesh whose topology stays fixed, set up once
    for repeated voxelization (voxelray_tpu/ops/voxelize.py:456).

    origin, voxel_size and dims follow the JAX package's math (the bbox
    of the plan-time vertices unless bb_min / bb_max are given).
    `buckets` holds JAX's bucketing, [(window shape + window_slack,
    faces (K, 3) numpy), ...], by the effective extents or, with
    deform_safe=True, by the full reference windows; the plan describes
    itself with them, and K1 does not read them: it walks each
    triangle's own window from the vertices it is given.  The faces go
    to `device` (default: the CUDA card) once, as contiguous int32,
    after a host check of their indices.  JAX's `chunk`, `layout` and
    `faces_sorted` only shape XLA's static programs and are left out.
    """

    def __init__(self, vertices, faces, voxel_size, *, bb_min=None,
                 bb_max=None, max_buckets=24, window_slack=(0, 0, 0),
                 deform_safe=False, device=None):
        from .kernels.voxel_accum import check_sizes

        v = np.asarray(vertices, np.float32).reshape(-1, 3)
        f = np.asarray(faces).reshape(-1, 3)
        if len(f) and (f.min() < 0 or f.max() >= len(v)):
            raise ValueError("faces index a vertex out of range")
        if bb_min is None or bb_max is None:
            bb_min, bb_max = mesh_bbox(v)
        self.device = resolve_device(device)
        self.origin = np.asarray(bb_min, np.float32)
        self.voxel_size = float(voxel_size)
        self.dims = grid_dims(self.origin, np.asarray(bb_max, np.float32),
                              voxel_size)
        self.buckets = [
            (tuple(int(w + s) for w, s in zip(win, window_slack)), f[idx])
            for win, idx in plan_buckets(v, f, self.origin, voxel_size,
                                         self.dims, max_buckets,
                                         effective=not deform_safe)]
        self.n_triangles = len(f)
        self.n_vertices = len(v)
        if self.device.type == "cuda":
            check_sizes(self.dims, self.n_triangles)
        self.faces = torch.as_tensor(f.astype(np.int32),
                                     device=self.device).contiguous()

    def __call__(self, vertices):
        return voxelize_planned(self, vertices)


def plan_voxelize(vertices, faces, voxel_size, **kw) -> VoxelizePlan:
    return VoxelizePlan(vertices, faces, voxel_size, **kw)


def voxelize_planned(plan: VoxelizePlan, vertices):
    """Voxelize the plan's faces over (possibly deformed) vertices.

    vertices: (V, 3) float32, numpy or a tensor, V the plan's vertex
    count.  Returns (occ (Z, Y, X) uint8, set_calls 0-d int64) on the
    plan's device.  On CUDA: one K1 launch and no host sync, so the
    frames of a deforming mesh queue back to back (given vertices
    already on the card: numpy input is copied there first).  On the
    CPU: voxelize_plain.  K1 works out each triangle's window from these
    vertices, so the result equals voxelize_mesh with the plan's bbox
    for any vertices, where JAX's plan is exact only while no window
    outgrows its bucket.  JAX's scatter="window" (a TPU A/B path) and
    count_only (a profiling mode) are not ported.
    """
    from .kernels.voxel_accum import accumulate

    v = torch.as_tensor(vertices, dtype=torch.float32,
                        device=plan.device).reshape(-1, 3)
    if v.shape[0] != plan.n_vertices:
        raise ValueError(f"{v.shape[0]} vertices; the plan has "
                         f"{plan.n_vertices}")
    if plan.device.type == "cpu":
        occ, calls = voxelize_plain(v, plan.faces, plan.origin,
                                    plan.voxel_size, plan.dims)
        return occ, torch.tensor(calls, dtype=torch.int64)
    if plan.device.type != "cuda":
        raise ValueError(f"voxelize_planned: unsupported device "
                         f"{plan.device}")
    occ, counts = accumulate(v.contiguous(), plan.faces, plan.origin,
                             plan.voxel_size, plan.dims)
    return occ, counts[0]
