"""Exhaustive traversal: the Amanatides-Woo DDA over a dense grid, and
the brute-force AABB and triangle traces.

Counterpart of trace_grid_dda / any_hit_grid_dda /
trace_grid_dda_chunked / trace_grid_dda_zslab, trace_aabbs_brute /
any_hit_aabbs_brute and trace_triangles_brute / any_hit_triangles_brute
in voxelray_tpu/ops/traverse.py.  Hit semantics
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
           "trace_grid_dda_zslab", "trace_aabbs_brute", "any_hit_aabbs_brute",
           "trace_triangles_brute", "any_hit_triangles_brute"]


def _per_ray(x, n, device):
    """Scalar or (...)-shaped bound -> (n,) float32 tensor.  A Python or
    numpy scalar is filled in on the device (no host-to-device copy, which
    would wait for the device)."""
    if not torch.is_tensor(x) and np.ndim(x) == 0:
        return torch.full((n,), float(np.float32(x)), dtype=torch.float32,
                          device=device)
    t = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x)
                        else x, dtype=torch.float32, device=device)
    return t.expand(n) if t.dim() == 0 else t.reshape(-1)


def _dda_init(o, d, origin, dims, vs):
    """Entry state of each ray: (cell (N, 3) int32, inside (N,), t_in
    (N,) = max(t_enter, 0), entry axis (N,), grid_max (3,))."""
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
    enter_axis = torch.where(t_enter == tn[:, 0], 0,
                             torch.where(t_enter == tn[:, 1], 1, 2))
    t_in = torch.clamp(t_enter, min=0.0)
    # start marginally inside the first cell
    t_start = t_in + 1e-7
    inside = t_exit > t_in
    p = o + d * t_start[:, None]
    hi = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.int32,
                      device=o.device)
    cell = torch.minimum(torch.clamp(
        torch.floor(div_scalar(p - origin, vs)).to(torch.int32), min=0), hi)
    return cell, inside, t_in, enter_axis, grid_max


def _dda_cell_hit_t(cell, o, d, origin, vs):
    """Slab t0 of the cell AABB built with the reference's float expr."""
    half = float(np.float32(0.5) * np.float32(vs))
    c = origin + (cell.to(torch.float32) + 0.5) * vs
    return hit_aabb(c - half, c + half, o, d)


def _cell_slab(cell, o, inv, origin, vs):
    """[t0, t1] of the cell AABB along the ray with inv = 1 / d
    (hit_aabb's expression, without its predicate)."""
    half = float(np.float32(0.5) * np.float32(vs))
    c = origin + (cell.to(torch.float32) + 0.5) * vs
    tb = inv * ((c - half) - o)
    tt = inv * ((c + half) - o)
    lo = torch.minimum(tt, tb)
    hi = torch.maximum(tt, tb)
    return (torch.maximum(lo[..., 0], torch.maximum(lo[..., 1], lo[..., 2])),
            torch.minimum(hi[..., 0], torch.minimum(hi[..., 1], hi[..., 2])))


def _dda_final_t(lin, o, d, origin, vs, dims):
    """t of the hit cell recomputed from its index (+inf where lin < 0)."""
    nx, ny, _ = dims
    hit = lin >= 0
    lin_s = torch.clamp(lin, min=0).long()
    cell = torch.stack([lin_s % nx, (lin_s // nx) % ny, lin_s // (nx * ny)],
                       dim=-1)
    t = _dda_cell_hit_t(cell, o, d, origin, vs)
    return torch.where(hit, t, torch.full_like(t, float("inf")))


# Two crossing times count as tied when they lie within this many ulps of
# the largest coordinate in play, over the direction components: the
# megakernel's kTieUlps (csrc/mega_trace.cu).
TIE_ULPS = 16.0


def trace_grid_dda(origins, dirs, occ_flat, grid_origin, *, dims,
                   voxel_size, t_min=TMIN, t_max=TMAX, admit=None):
    """Nearest accepted occupied cell along each ray.

    origins/dirs: (..., 3) float32; occ_flat: (X*Y*Z,) uint8 on the same
    device; grid_origin: (3,) float32.  t_min/t_max: scalars or per-ray
    (...) tensors; admit: optional bool (...) mask (non-admitted rays
    miss).  Returns (t, lin) with t = +inf / lin = -1 on miss.

    Near-ties repair the reference walk, as the megakernel does
    (pick_axis / probe_cell in csrc/mega_trace.cu): where crossing times
    lie within float noise of each other the ray passes next to an edge
    or corner, and the reference's per-cell slab tests, which are not
    watertight there, may accept a sliver on either side.  So the step
    goes to the first tied neighbour (nearest axis first, then x, y, z)
    that the slab test says the ray passes through, the other tied
    neighbours are probed, and so are the cells behind the start cell's
    entry faces; a probed hit retires the ray once the walk passes its t.
    Crossing times are computed from the cell, not accumulated.
    """
    return _dda(origins, dirs, occ_flat, grid_origin, dims, voxel_size,
                t_min, t_max, admit, 0, dims[2])


def trace_grid_dda_zslab(origins, dirs, occ_slab_flat, grid_origin, z0, *,
                         dims, nzs, voxel_size, t_min=TMIN, t_max=TMAX):
    """The DDA over one Z-slab of a grid sharded over devices
    (voxelray_tpu/ops/traverse.py:391-480): global coordinates, global
    linear cell ids, (+inf, -1) where the slab has no accept.

    occ_slab_flat: (nx * ny * nzs,) uint8, the grid's rows [z0, z0 + nzs)
    x fastest (rows past the grid empty); dims stays the full grid's.
    Unlike JAX's, which clips each ray to the slab's box (and so starts
    from another float expression than the monolithic walk), every ray
    walks trace_grid_dda's walk from the grid's entry, with its steps,
    near-tie rule and probes, reading only the slab's rows (the others
    are empty) and stopping once it has passed them.  The steps do not
    depend on the occupancy, and the probes look ahead along the walk
    (or, at the start, behind it, which every slab does), so each slab
    meets its cells as the monolithic walk does and none needs a halo:
    the min-t merge over slabs (ties to the smaller cell id) gives
    trace_grid_dda's cell.
    """
    return _dda(origins, dirs, occ_slab_flat, grid_origin, dims, voxel_size,
                t_min, t_max, None, z0, nzs)


def _dda(origins, dirs, occ_flat, grid_origin, dims, voxel_size, t_min,
         t_max, admit, z_lo, n_rows):
    """The walk of trace_grid_dda with occ_flat holding the grid's rows
    [z_lo, z_lo + n_rows) only; a ray stops once its walk leaves them."""
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
    base = z_lo * nx * ny
    if occ.numel() == 0:
        occ = torch.zeros(1, dtype=torch.uint8, device=dev)
    w_lo, w_hi = max(z_lo, 0), min(z_lo + n_rows, nz)
    windowed = w_lo > 0 or w_hi < nz

    def occ_at(cells, lin):
        """Occupancy of in-grid cells (lin their linear ids): the held
        rows' words, empty elsewhere."""
        z = cells[..., 2]
        return ((z >= z_lo) & (z < z_lo + n_rows)
                & (occ[torch.clamp(lin - base, 0, occ.numel() - 1)] > 0))

    cell, active, t_in, enter_axis, grid_max = _dda_init(o, d, origin, dims,
                                                         vs)
    if admit is not None:
        active = active & admit.reshape(-1).to(torch.bool)
    inf = float("inf")
    dims_t = torch.tensor([nx, ny, nz], device=dev)
    eye = torch.eye(3, dtype=torch.int64, device=dev)
    # the nonempty subsets m = 1..7 of the three axes, as cell offsets
    masks = torch.arange(1, 8, device=dev)
    subsets = (masks[:, None] >> torch.arange(3, device=dev)) & 1

    # The active rays only, their constants packed so that dropping the
    # retired rays costs two gathers: f = [o | d | 1/d | |1/d| | t_min,
    # t_max, tie_eps], i = [ray index | step | far face]
    idx = torch.nonzero(active).squeeze(1)
    o, d, cell = o[idx], d[idx], cell[idx].long()
    inv = 1.0 / d
    scale = torch.maximum(
        o.abs().amax(dim=1),
        torch.maximum(origin.abs().max(), grid_max.abs().max()))
    f = torch.cat([o, d, inv, inv.abs(), tmn[idx, None], tmx[idx, None],
                   ((TIE_ULPS * 2.0 ** -24) * scale)[:, None]], dim=1)
    far = (d >= 0).long()
    i = torch.cat([idx[:, None], 2 * far - 1, far], dim=1)
    moving = d != 0.0
    best_t = torch.full((idx.numel(),), inf, device=dev)
    best_lin = torch.full((idx.numel(),), -1, dtype=torch.int64, device=dev)

    def probe_around(rows, fr, cr, axes, skip, sign):
        """For the active rays `rows` (their f rows fr, cells cr): test
        the cells across every nonempty set of their `axes` ((R, 3) bool,
        each crossed towards `sign` (R, 3)) but the set `skip` ((R,) bit
        mask): the face neighbours and the edge and corner neighbours
        between them.  The nearest accepted occupied cell (the first set
        on equal t) replaces (best_t, best_lin) where it is nearer."""
        bits = (axes.long() << torch.arange(3, device=dev)).sum(1)
        want = ((bits[:, None] & masks) == masks) & (skip[:, None] != masks)
        cells = cr[:, None, :] + subsets * sign[:, None, :]    # (R, 7, 3)
        inb = ((cells >= 0) & (cells < dims_t)).all(dim=-1)
        lin = cells[..., 0] + nx * (cells[..., 1] + ny * cells[..., 2])
        occ_c = occ_at(cells, lin)
        t0, t1 = _cell_slab(cells, fr[:, None, 0:3], fr[:, None, 6:9],
                            origin, vs)
        ok = (want & inb & occ_c & (t1 > torch.clamp(t0, min=0.0))
              & (t0 > 0.0) & (t0 >= fr[:, 12:13]) & (t0 <= fr[:, 13:14]))
        t0 = torch.where(ok, t0, torch.full_like(t0, inf))
        j = torch.argmin(t0, dim=1, keepdim=True)
        tj, lj = t0.gather(1, j)[:, 0], lin.gather(1, j)[:, 0]
        better = tj < best_t[rows]
        best_t[rows] = torch.where(better, tj, best_t[rows])
        best_lin[rows] = torch.where(better, lj, best_lin[rows])

    def crossings(faces):
        """Each axis' crossing t of the current cell's face `faces` (0:
        min, 1: max), +inf on an axis the ray does not move along."""
        t = (origin + (cell + faces).to(torch.float32) * vs - f[:, 0:3]) \
            * f[:, 6:9]
        return torch.where(moving, t, torch.full_like(t, inf))

    # the start cell floors the entry point: where the ray crosses its
    # entry faces within noise of the entry time, probe the cells behind
    ainv = f[:, 9:12]
    behind = moving & ((crossings(1 - far) - t_in[idx, None]).abs()
                       <= f[:, 14:15] * (ainv + ainv.gather(
                           1, enter_axis[idx, None])))
    rows = torch.nonzero(behind.any(dim=1)).squeeze(1)
    if rows.numel():
        probe_around(rows, f[rows], cell[rows], behind[rows],
                     torch.zeros_like(rows), -i[rows, 1:4])

    for _ in range(nx + ny + nz + 3):
        if cell.shape[0] == 0:
            break
        step, ainv = i[:, 1:4], f[:, 9:12]
        lin = cell[:, 0] + nx * (cell[:, 1] + ny * cell[:, 2])
        occ_here = occ_at(cell, lin)
        t0, t1 = _cell_slab(cell, f[:, 0:3], f[:, 6:9], origin, vs)
        ok = (occ_here & (t1 > torch.clamp(t0, min=0.0)) & (t0 > 0.0)
              & (t0 >= f[:, 12]) & (t0 <= f[:, 13]))
        best_lin = torch.where(ok & (t0 < best_t), lin, best_lin)
        best_t = torch.where(ok, torch.minimum(t0, best_t), best_t)
        # the axis with the nearest crossing (ties: x, y, z)
        t_next = crossings(i[:, 4:7])
        t_cross = t_next.amin(dim=1)
        axis = torch.where(t_next[:, 0] == t_cross, 0,
                           torch.where(t_next[:, 1] == t_cross, 1, 2))
        done = ok | (best_t <= t_cross)
        # near-ties: the first neighbour the slab test passes through, and
        # probes of the others
        near = torch.isfinite(t_next) & (
            t_next - t_cross[:, None]
            <= f[:, 14:15] * (ainv + ainv.gather(1, axis[:, None])))
        near |= eye[axis].bool()
        tied = torch.nonzero(~done & (near.sum(dim=1) > 1)).squeeze(1)
        if tied.numel():
            ft, ct, st, nt, at = (f[tied], cell[tied], step[tied],
                                  near[tied], axis[tied])
            s0, s1 = _cell_slab(ct[:, None, :] + eye * st[:, None, :],
                                ft[:, None, 0:3], ft[:, None, 6:9], origin,
                                vs)                          # (T, 3)
            pick = nt & (s1 > s0)
            own = pick.gather(1, at[:, None])[:, 0]
            first = torch.where(pick[:, 0], 0, torch.where(pick[:, 1], 1, 2))
            at = torch.where(own | ~pick.any(dim=1), at, first)
            axis[tied] = at
            probe_around(tied, ft, ct, nt, 1 << at, st)
        done |= t_cross > f[:, 13]
        cell = cell + eye[axis] * step
        done |= ~((cell >= 0) & (cell < dims_t)).all(dim=1)
        if windowed:
            # past the held rows in the walk's z direction
            z, dz = cell[:, 2], f[:, 5]
            done |= torch.where(dz < 0, z < w_lo, torch.where(
                dz > 0, z >= w_hi, (z < w_lo) | (z >= w_hi)))
        if bool(done.any()):
            fin = torch.nonzero(done).squeeze(1)
            lin_out[i[fin, 0]] = best_lin[fin].to(torch.int32)
            k = torch.nonzero(~done).squeeze(1)
            f, i, cell, moving = f[k], i[k], cell[k], moving[k]
            best_t, best_lin = best_t[k], best_lin[k]
    lin_out[i[:, 0]] = best_lin.to(torch.int32)
    o = origins.reshape(-1, 3).to(torch.float32)
    d = dirs.reshape(-1, 3).to(torch.float32)
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
