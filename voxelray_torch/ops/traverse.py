"""Exhaustive traversal: the Amanatides-Woo DDA over a dense grid, and
the brute-force AABB and triangle traces.

Counterpart of trace_grid_dda / any_hit_grid_dda /
trace_grid_dda_chunked, trace_aabbs_brute / any_hit_aabbs_brute and
trace_triangles_brute / any_hit_triangles_brute in
voxelray_tpu/ops/traverse.py.  Hit semantics
(the VK_KHR_ray_tracing report/accept rules the reference's shaders rely
on): a voxel is hit at the slab t0 iff

    t1 > max(t0, 0)        (the rint predicate)
    t0 > 0                 (the rint report guard)
    t_min <= t0 <= t_max   (hardware ray-interval clamp)

and the nearest accepted t0 wins, which for a grid walk is the first
accepted occupied cell.  This is the exhaustive comparator of the fast
path and the plain version of the megakernel K2
(ops/kernels/mega_trace.py): t_min and t_max may be per ray, and an
`admit` mask starts only the selected rays.

The walk runs one vectorized step at a time over the rays still active,
compacting them as they retire; its step bound is nx+ny+nz+3 as in the
JAX package.  The final t is recomputed from the hit cell with the
hit_aabb expression (`_dda_final_t`), term for term the expression of
the megakernel's per-voxel step, so where the two find the same cell
they give the same t.
"""
from __future__ import annotations

import numpy as np
import torch

from .geometry import div_scalar
from .intersect import TMAX, TMIN, hit_aabb, hit_triangles

__all__ = ["trace_grid_dda", "any_hit_grid_dda", "trace_grid_dda_chunked",
           "trace_aabbs_brute", "any_hit_aabbs_brute",
           "trace_triangles_brute", "any_hit_triangles_brute"]


def _per_ray(x, n, device):
    """Scalar or (...)-shaped bound -> (n,) float32 tensor."""
    t = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x)
                        else x, dtype=torch.float32, device=device)
    return t.expand(n) if t.dim() == 0 else t.reshape(-1)


def _dda_init(o, d, origin, dims, vs):
    """Entry cell + boundary-crossing state for each ray:
    (cell (N, 3) int32, t_next (N, 3), inside (N,))."""
    nx, ny, nz = dims
    dims_f = torch.tensor([nx, ny, nz], dtype=torch.float32, device=o.device)
    grid_max = origin + dims_f * vs
    inv_d = 1.0 / d
    tbot = inv_d * (origin - o)
    ttop = inv_d * (grid_max - o)
    tn = torch.minimum(tbot, ttop)
    tf = torch.maximum(tbot, ttop)
    t_enter = torch.maximum(torch.maximum(tn[:, 0], tn[:, 1]), tn[:, 2])
    t_exit = torch.minimum(torch.minimum(tf[:, 0], tf[:, 1]), tf[:, 2])
    # start marginally inside the first cell
    t_start = torch.clamp(t_enter, min=0.0) + 1e-7
    inside = t_exit > torch.clamp(t_enter, min=0.0)
    p = o + d * t_start[:, None]
    hi = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.int32,
                      device=o.device)
    cell = torch.minimum(torch.clamp(
        torch.floor(div_scalar(p - origin, vs)).to(torch.int32), min=0), hi)
    step_pos = d >= 0
    next_bound = origin + (cell + step_pos.to(torch.int32)) \
        .to(torch.float32) * vs
    t_next = torch.where(d != 0.0, (next_bound - o) * inv_d,
                         torch.full_like(d, float("inf")))
    return cell, t_next, inside


def _dda_cell_hit_t(cell, o, d, origin, vs):
    """Slab t0 of the cell AABB built with the reference's float expr."""
    half = float(np.float32(0.5) * np.float32(vs))
    c = origin + (cell.to(torch.float32) + 0.5) * vs
    return hit_aabb(c - half, c + half, o, d)


def _dda_final_t(lin, o, d, origin, vs, dims):
    """t of the hit cell recomputed from its index (+inf where lin < 0)."""
    nx, ny, _ = dims
    hit = lin >= 0
    lin_s = torch.clamp(lin, min=0).long()
    cell = torch.stack([lin_s % nx, (lin_s // nx) % ny, lin_s // (nx * ny)],
                       dim=-1)
    t = _dda_cell_hit_t(cell, o, d, origin, vs)
    return torch.where(hit, t, torch.full_like(t, float("inf")))


def trace_grid_dda(origins, dirs, occ_flat, grid_origin, *, dims,
                   voxel_size, t_min=TMIN, t_max=TMAX, admit=None):
    """Nearest accepted occupied cell along each ray.

    origins/dirs: (..., 3) float32; occ_flat: (X*Y*Z,) uint8 on the same
    device; grid_origin: (3,) float32.  t_min/t_max: scalars or per-ray
    (...) tensors; admit: optional bool (...) mask (non-admitted rays
    miss).  Returns (t, lin) with t = +inf / lin = -1 on miss.
    """
    nx, ny, nz = dims
    batch = origins.shape[:-1]
    dev = origins.device
    vs = float(np.float32(voxel_size))
    origin = torch.as_tensor(np.asarray(grid_origin, np.float32)
                             if not torch.is_tensor(grid_origin)
                             else grid_origin, dtype=torch.float32,
                             device=dev)
    o = origins.reshape(-1, 3).to(torch.float32)
    d = dirs.reshape(-1, 3).to(torch.float32)
    n = o.shape[0]
    tmn = _per_ray(t_min, n, dev)
    tmx = _per_ray(t_max, n, dev)
    lin_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    n_cells = nx * ny * nz
    if n == 0 or n_cells == 0:
        return (torch.full(batch, float("inf"), device=dev),
                lin_out.reshape(batch))
    occ = occ_flat.reshape(-1)

    cell, t_next, active = _dda_init(o, d, origin, dims, vs)
    if admit is not None:
        active = active & admit.reshape(-1).to(torch.bool)
    step = torch.where(d >= 0, 1, -1).to(torch.int32)
    t_delta = torch.where(d != 0.0, vs * torch.abs(1.0 / d),
                          torch.full_like(d, float("inf")))
    dims_t = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)

    # state of the active rays only; idx maps them back
    idx = torch.nonzero(active).squeeze(1)
    s_o, s_d, s_cell, s_tn = o[idx], d[idx], cell[idx], t_next[idx]
    s_step, s_td, s_tmn, s_tmx = step[idx], t_delta[idx], tmn[idx], tmx[idx]
    for _ in range(nx + ny + nz + 3):
        if idx.numel() == 0:
            break
        lin = s_cell[:, 0] + nx * (s_cell[:, 1] + ny * s_cell[:, 2])
        occ_here = occ[torch.clamp(lin, 0, n_cells - 1).long()] > 0
        t0 = _dda_cell_hit_t(s_cell, s_o, s_d, origin, vs)
        ok = occ_here & (t0 > 0.0) & (t0 >= s_tmn) & (t0 <= s_tmx)
        lin_out[idx[ok]] = lin[ok]
        keep = ~ok
        # step along the axis with the nearest boundary (ties: x, y, z)
        tx, ty, tz = s_tn.unbind(1)
        sx = (tx <= ty) & (tx <= tz)
        sy = ~sx & (ty <= tz)
        sz = ~(sx | sy)
        t_cross = torch.where(sx, tx, torch.where(sy, ty, tz))
        keep &= t_cross <= s_tmx
        onehot = torch.stack([sx, sy, sz], dim=1)
        s_cell = s_cell + torch.where(onehot, s_step, 0)
        s_tn = torch.where(onehot, s_tn + s_td, s_tn)
        keep &= ((s_cell >= 0) & (s_cell < dims_t)).all(dim=1)
        if not bool(keep.all()):
            k = torch.nonzero(keep).squeeze(1)
            idx, s_o, s_d, s_cell, s_tn = (idx[k], s_o[k], s_d[k],
                                           s_cell[k], s_tn[k])
            s_step, s_td, s_tmn, s_tmx = (s_step[k], s_td[k], s_tmn[k],
                                          s_tmx[k])
    t = _dda_final_t(lin_out, o, d, origin, vs, dims)
    return t.reshape(batch), lin_out.reshape(batch)


def any_hit_grid_dda(origins, dirs, occ_flat, grid_origin, *, dims,
                     voxel_size, t_min=TMIN, t_max=TMAX, admit=None):
    """Shadow predicate via the DDA; t_max may be per ray."""
    t, _ = trace_grid_dda(origins, dirs, occ_flat, grid_origin, dims=dims,
                          voxel_size=voxel_size, t_min=t_min, t_max=t_max,
                          admit=admit)
    return torch.isfinite(t)


def trace_grid_dda_chunked(origins, dirs, occ_flat, grid_origin, *, dims,
                           voxel_size, t_min=TMIN, t_max=TMAX,
                           ray_chunk=1 << 20):
    """trace_grid_dda over ray chunks of at most ray_chunk rays, which
    bounds the walk's working set at full-frame sizes."""
    batch = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    n = o.shape[0]
    tmn = _per_ray(t_min, n, o.device)
    tmx = _per_ray(t_max, n, o.device)
    ts, lins = [], []
    for c0 in range(0, n, ray_chunk):
        c1 = min(c0 + ray_chunk, n)
        t, lin = trace_grid_dda(o[c0:c1], d[c0:c1], occ_flat, grid_origin,
                                dims=dims, voxel_size=voxel_size,
                                t_min=tmn[c0:c1], t_max=tmx[c0:c1])
        ts.append(t)
        lins.append(lin)
    if not ts:
        return (torch.full(batch, float("inf"), device=o.device),
                torch.full(batch, -1, dtype=torch.int32, device=o.device))
    return torch.cat(ts).reshape(batch), torch.cat(lins).reshape(batch)


def trace_aabbs_brute(origins, dirs, aabbs, t_min=TMIN, t_max=TMAX):
    """Nearest voxel hit by the slab test of every box: the semantic
    reference, for any AABB soup (GridVec's duplicates included).

    origins/dirs: (..., 3); aabbs: (N, 6) [min | max] on the same device;
    t_min/t_max scalars or per ray.  Returns (t, prim_id), t = +inf /
    prim_id = -1 on a miss.  Ties go to the lowest box index, so of
    duplicate boxes the first copy is reported.  Boxes are taken in
    chunks of about 2^24 ray-box pairs.
    """
    batch = origins.shape[:-1]
    dev = origins.device
    o = origins.reshape(-1, 3).to(torch.float32)[:, None, :]
    d = dirs.reshape(-1, 3).to(torch.float32)[:, None, :]
    n, m = o.shape[0], aabbs.shape[0]
    best_t = torch.full((n,), float("inf"), device=dev)
    best_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    tmn = _per_ray(t_min, n, dev)[:, None]
    tmx = _per_ray(t_max, n, dev)[:, None]
    chunk = max(256, (1 << 24) // max(n, 1))
    for c0 in range(0, m, chunk):
        box = aabbs[c0:c0 + chunk]
        t0 = hit_aabb(box[:, 0:3], box[:, 3:6], o, d)
        ok = (t0 > 0.0) & (t0 >= tmn) & (t0 <= tmx)
        t0 = torch.where(ok, t0, torch.full_like(t0, float("inf")))
        arg = torch.argmin(t0, dim=1, keepdim=True)
        tb = t0.gather(1, arg)[:, 0]
        better = tb < best_t
        best_id = torch.where(better, arg[:, 0].to(torch.int32) + c0, best_id)
        best_t = torch.where(better, tb, best_t)
    return best_t.reshape(batch), best_id.reshape(batch)


def any_hit_aabbs_brute(origins, dirs, aabbs, t_min=TMIN, t_max=TMAX):
    """Shadow predicate over every box; t_max may be per ray."""
    t, _ = trace_aabbs_brute(origins, dirs, aabbs, t_min=t_min, t_max=t_max)
    return torch.isfinite(t)


def trace_triangles_brute(origins, dirs, v0, v1, v2, t_min=TMIN, t_max=TMAX):
    """Nearest triangle hit by testing every triangle (the Vulkan
    triangle BLAS, in software).

    origins/dirs: (..., 3); v0/v1/v2: (F, 3) triangle corners on the same
    device; t_min/t_max scalars or per-ray.  Returns (t, prim_id, u, v),
    t = +inf / prim_id = -1 on a miss.  Ties go to the lowest triangle
    index.  Triangles are taken in chunks of about 2^24 ray-triangle
    pairs.
    """
    batch = origins.shape[:-1]
    dev = origins.device
    o = origins.reshape(-1, 3).to(torch.float32)
    d = dirs.reshape(-1, 3).to(torch.float32)
    n, f = o.shape[0], v0.shape[0]
    best_t = torch.full((n,), float("inf"), device=dev)
    best_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), device=dev)
    best_v = torch.zeros((n,), device=dev)
    tmn = _per_ray(t_min, n, dev)[:, None]
    tmx = _per_ray(t_max, n, dev)[:, None]
    chunk = max(256, (1 << 24) // max(n, 1))
    for c0 in range(0, f, chunk):
        c1 = min(c0 + chunk, f)
        t, u, v = hit_triangles(o[:, None, :], d[:, None, :], v0[c0:c1],
                                v1[c0:c1], v2[c0:c1], t_min=tmn, t_max=tmx)
        arg = torch.argmin(t, dim=1, keepdim=True)
        tb = t.gather(1, arg)[:, 0]
        better = tb < best_t
        best_id = torch.where(better, arg[:, 0].to(torch.int32) + c0, best_id)
        best_t = torch.where(better, tb, best_t)
        best_u = torch.where(better, u.gather(1, arg)[:, 0], best_u)
        best_v = torch.where(better, v.gather(1, arg)[:, 0], best_v)
    return (best_t.reshape(batch), best_id.reshape(batch),
            best_u.reshape(batch), best_v.reshape(batch))


def any_hit_triangles_brute(origins, dirs, v0, v1, v2, t_min=TMIN,
                            t_max=TMAX):
    """Shadow predicate over every triangle; t_max may be per ray."""
    t, _, _, _ = trace_triangles_brute(origins, dirs, v0, v1, v2,
                                       t_min=t_min, t_max=t_max)
    return torch.isfinite(t)
