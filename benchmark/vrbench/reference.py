"""The plain reference: what a frame of the fly-through should look like.

Plain PyTorch, on whatever device it is given, importing nothing of the
program and reading nothing the program built: it works the grid, the
voxelization, its own triangle grid, the camera rays, the traces and the
shading out again from the benchmark's mesh and cameras
(`inputs.py`).  It follows the reference app's per-pixel contract, as
voxelray_torch/oracle_render.py transcribes it (brute force there):

  raygen       d = ((pixel + 0.5) / size) * 2 - 1; origin = viewInverse
               * (0,0,0,1); dir = viewInverse * normalize(projInverse *
               (d.x, d.y, 1, 1)) (raytrace.rgen:41-47), t in [0.001, 1e4]
  voxel hit    the occupied cell whose slab entry t0 is nearest with
               t1 > max(t0, 0) and t_min <= t0 <= t_max (raytrace.rint)
  tri hit      Moller-Trumbore, no culling, |det| > 1e-8, u, v >= 0,
               u + v <= 1, t_min < t < t_max
  voxel CH     dominant-axis cube normal, ties x over y over z,
               attenuation 0.3 unless facing the light and unshadowed
               (raytrace2.rchit)
  tri CH       the face normal (the streams' flat normals), attenuation 1
               unless facing and shadowed -> 0.3 (raytrace.rchit)
  light        point light, intensity / d^2 (raytrace.rchit:77-91);
               diffuse Lambert + ambient if illum >= 1, Phong specular if
               illum >= 2 and lit (wavefront.glsl)
  miss         clearColor * 0.8; post: pow(rgba, 1 / 2.2)

The voxelizer is the reference app's serial SAT (VoxelBuilder.hpp:118-196,
voxelray_torch/oracle.py): float32 with the same expression shapes, so
its occupancy and set_calls are exact.  The traces are exhaustive cell
walks (Amanatides-Woo, every crossing recomputed from the cell index, no
accumulated error) in `dtype`, float64 by default: a voxel walk over the
occupancy, and a walk over a uniform grid of the triangles' bounding
boxes that tests every triangle listed in each cell it crosses.
`dtype=torch.bfloat16` is the control: the same reference with its
voxelize, rays, walks and hit points a precision below the
configuration's float32 (its colours are shaded in float32 from them).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["T_MIN", "T_MAX", "voxelize", "sat_tests", "camera_rays",
           "VoxelScene",
           "TriangleScene", "render", "admitted", "SAT_EPS"]

T_MIN, T_MAX = 0.001, 10000.0
SAT_EPS = 1e-8
SLOTS = 1 << 22          # window cells per voxelize chunk
PAIRS = 1 << 23          # (ray, triangle) tests per chunk
INF = float("inf")
NO_ID = torch.iinfo(torch.int64).max


# ---------------------------------------------------------------- voxelize

def _sat(c, h, v0, v1, v2):
    """Akenine-Moller SAT, triBoxOverlap (VoxelBuilder.hpp:118-162) in the
    oracle's expression shapes; c (N, 3) centres, v* (N, 3)."""
    p0, p1, p2 = v0 - c, v1 - c, v2 - c
    e0, e1, e2 = p1 - p0, p2 - p1, p0 - p2
    mn = torch.minimum(p0, torch.minimum(p1, p2))
    mx = torch.maximum(p0, torch.maximum(p1, p2))
    sep = ((mn > h) | (mx < -h)).any(dim=1)

    def axis_sep(ax, ay, az, r):
        l1 = ax.abs() + ay.abs() + az.abs()
        d0 = p0[:, 0] * ax + p0[:, 1] * ay + p0[:, 2] * az
        d1 = p1[:, 0] * ax + p1[:, 1] * ay + p1[:, 2] * az
        d2 = p2[:, 0] * ax + p2[:, 1] * ay + p2[:, 2] * az
        tmn = torch.minimum(d0, torch.minimum(d1, d2))
        tmx = torch.maximum(d0, torch.maximum(d1, d2))
        return (l1 >= SAT_EPS) & ((tmn > r) | (tmx < -r))

    zero = torch.zeros_like(p0[:, 0])
    for e in (e0, e1, e2):
        ex, ey, ez = e[:, 0], e[:, 1], e[:, 2]
        sep |= axis_sep(zero, -ez, ey, h * (-ez).abs() + h * ey.abs())
        sep |= axis_sep(ez, zero, -ex, h * ez.abs() + h * (-ex).abs())
        sep |= axis_sep(-ey, ex, zero, h * (-ey).abs() + h * ex.abs())
    nx = e0[:, 1] * e1[:, 2] - e0[:, 2] * e1[:, 1]
    ny = e0[:, 2] * e1[:, 0] - e0[:, 0] * e1[:, 2]
    nz = e0[:, 0] * e1[:, 1] - e0[:, 1] * e1[:, 0]
    nl1 = nx.abs() + ny.abs() + nz.abs()
    r = h * nx.abs() + h * ny.abs() + h * nz.abs()
    s = nx * p0[:, 0] + ny * p0[:, 1] + nz * p0[:, 2]
    sep |= (nl1 >= SAT_EPS) & (s.abs() > r)
    return ~sep


def _windows(v, f, origin, voxel_size, dims, device, dtype):
    """(triangles (F, 3, 3), origin, voxel size, each triangle's window
    start (F, 3) and extent (F, 3)) in `dtype`: the window [trunc((min -
    origin) / vs), trunc((max - origin) / vs) + 2) clamped to the grid
    (VoxelBuilder.hpp:175-184)."""
    tri = torch.as_tensor(np.asarray(v, np.float32)[np.asarray(f)],
                          device=device).to(dtype)
    org = torch.as_tensor(np.asarray(origin, np.float32),
                          device=device).to(dtype)
    vs = torch.tensor(float(np.float32(voxel_size)), dtype=dtype,
                      device=device)
    hi = torch.tensor(dims, dtype=torch.int64, device=device)
    tmin = torch.minimum(tri[:, 0], torch.minimum(tri[:, 1], tri[:, 2]))
    tmax = torch.maximum(tri[:, 0], torch.maximum(tri[:, 1], tri[:, 2]))
    start = torch.clamp(((tmin - org) / vs).to(torch.int64), min=0)
    end = torch.minimum(hi, ((tmax - org) / vs).to(torch.int64) + 2)
    return tri, org, vs, start, torch.clamp(end - start, min=0)


def sat_tests(v, f, origin, voxel_size, dims, device):
    """The SAT tests that voxelize makes: the cells of every triangle's
    clamped window, summed (float32, as the configuration states)."""
    w = _windows(v, f, origin, voxel_size, dims, device, torch.float32)[4]
    return int((w[:, 0] * w[:, 1] * w[:, 2]).sum())


def voxelize(v, f, origin, voxel_size, dims, device, dtype=torch.float32):
    """The reference app's serial voxelizer: (occ (Z, Y, X) bool, set_calls).

    Per triangle the window [trunc((min - origin) / vs), trunc((max -
    origin) / vs) + 2) clamped to the grid (VoxelBuilder.hpp:175-184),
    every cell of it SAT-tested; set_calls counts the hits, duplicates
    included.  v (V, 3) and f (F, 3) numpy; the arithmetic in `dtype`.
    """
    nx, ny, nz = dims
    occ = torch.zeros(nz * ny * nx, dtype=torch.bool, device=device)
    tri, org, vs, start, w = _windows(v, f, origin, voxel_size, dims,
                                      device, dtype)
    h = torch.tensor(float(np.float32(voxel_size * 0.5)), dtype=dtype,
                     device=device)
    cap = w[:, 0] * w[:, 1] * w[:, 2]
    calls = 0
    cum = torch.cumsum(cap, 0).cpu().numpy()
    t0 = 0
    while t0 < len(cap):
        base = int(cum[t0 - 1]) if t0 else 0
        t1 = int(np.searchsorted(cum, base + SLOTS, side="right"))
        t1 = max(t1, t0 + 1)
        ids = torch.arange(t0, t1, device=device)
        t = torch.repeat_interleave(ids, cap[t0:t1])
        first = torch.cumsum(cap[t0:t1], 0) - cap[t0:t1]
        k = torch.arange(t.shape[0], device=device) - first[t - t0]
        wx, wy = w[t, 0], w[t, 1]
        cx = start[t, 0] + k % wx
        cy = start[t, 1] + (k // wx) % wy
        cz = start[t, 2] + k // (wx * wy)
        centers = torch.stack([org[0] + (cx.to(dtype) + 0.5) * vs,
                               org[1] + (cy.to(dtype) + 0.5) * vs,
                               org[2] + (cz.to(dtype) + 0.5) * vs], dim=1)
        hit = _sat(centers, h, tri[t, 0], tri[t, 1], tri[t, 2])
        occ[(cx + nx * (cy + ny * cz))[hit]] = True
        calls += int(hit.sum())
        t0 = t1
    return occ.reshape(nz, ny, nx), calls


# --------------------------------------------------------------- camera rays

def camera_rays(view_inv, proj_inv, width, height, device, dtype):
    """Per-pixel (origins, dirs), (H * W, 3) row-major, in `dtype`."""
    vi = torch.as_tensor(np.asarray(view_inv, np.float32),
                         device=device).to(dtype)
    pi = torch.as_tensor(np.asarray(proj_inv, np.float32),
                         device=device).to(dtype)
    px = (torch.arange(width, device=device, dtype=dtype) + 0.5) \
        / width * 2.0 - 1.0
    py = (torch.arange(height, device=device, dtype=dtype) + 0.5) \
        / height * 2.0 - 1.0
    dy, dx = torch.meshgrid(py, px, indexing="ij")
    q = torch.stack([dx, dy, torch.ones_like(dx), torch.ones_like(dx)],
                    dim=-1).reshape(-1, 4)
    target = q @ pi.T
    tn = target[:, :3] / torch.linalg.vector_norm(target[:, :3], dim=1,
                                                  keepdim=True)
    dirs = tn @ vi[:3, :3].T
    return vi[:3, 3].expand(dirs.shape), dirs


# ------------------------------------------------------------ the cell walk

class _Walk:
    """Amanatides-Woo over a grid (origin, cell size, dims), every crossing
    time recomputed from the cell index.  Each step hands the live rays'
    current cells with their slab entry and exit times to `visit`."""

    def __init__(self, origin, cell, dims, device, dtype):
        self.lo = torch.as_tensor(np.asarray(origin, np.float64),
                                  device=device).to(dtype)
        self.cell = torch.tensor(float(cell), dtype=dtype, device=device)
        self.dims = torch.tensor(dims, dtype=torch.int64, device=device)
        self.hi = self.lo + self.dims.to(dtype) * self.cell
        self.dtype = dtype

    def _cross(self, bound, o, d):
        """(bound - o) / d per axis; +inf where d == 0."""
        return torch.where(d != 0, (bound - o) / torch.where(
            d != 0, d, torch.ones_like(d)), torch.full_like(d, INF))

    def run(self, o, d, t_max, visit):
        """Walk rays o, d (N, 3) up to t_max (N,).  visit(ids, lin, t0, t1)
        returns (done, values): done (M,) bool over the rays it was given,
        values a tuple of tensors over the done ones.  Returns the list of
        (ray ids, values) of every step; a ray is done at most once."""
        ta = self._cross(self.lo, o, d)
        tb = self._cross(self.hi, o, d)
        t_in = torch.minimum(ta, tb).amax(dim=1)
        t_out = torch.maximum(ta, tb).amin(dim=1)
        t_start = torch.clamp(t_in, min=0.0)
        live = (t_out >= t_start) & (t_start <= t_max) & (t_out >= T_MIN)
        ids = torch.nonzero(live).squeeze(1)
        p = o[ids] + d[ids] * t_start[ids, None]
        cell = torch.floor((p - self.lo) / self.cell).to(torch.int64)
        cell = torch.minimum(torch.clamp(cell, min=0), self.dims - 1)
        step = torch.where(d[ids] > 0, 1, -1).to(torch.int64)
        results = []
        nx, ny = int(self.dims[0]), int(self.dims[1])
        while ids.numel():
            oi, di = o[ids], d[ids]
            c_lo = self.lo + cell.to(self.dtype) * self.cell
            ca = self._cross(c_lo, oi, di)
            cb = self._cross(c_lo + self.cell, oi, di)
            t0 = torch.minimum(ca, cb).amax(dim=1)
            t1 = torch.maximum(ca, cb).amin(dim=1)
            lin = cell[:, 0] + nx * (cell[:, 1] + ny * cell[:, 2])
            done, values = visit(ids, lin, t0, t1)
            results.append((ids[done], values))
            # the next cell: across the face the ray leaves by first
            axis = torch.argmin(torch.where(step > 0, cb, ca), dim=1)
            cell = cell + torch.nn.functional.one_hot(axis, 3) * step
            inside = ((cell >= 0) & (cell < self.dims)).all(dim=1)
            keep = torch.nonzero(~done & inside & (t1 <= t_max[ids]))
            keep = keep.squeeze(1)
            ids, cell, step = ids[keep], cell[keep], step[keep]
        return results


def _gather(results, n, fills, device):
    """Per-ray tensors from a walk's results; `fills` (value, dtype) for
    the rays never done."""
    outs = [torch.full((n,), v, dtype=dt, device=device) for v, dt in fills]
    for ids, values in results:
        for out, val in zip(outs, values):
            out[ids] = val.to(out.dtype)
    return outs


class VoxelScene:
    """The voxel scene: the reference's own occupancy on the grid."""

    def __init__(self, occ, origin, voxel_size, dims, dtype=torch.float64):
        self.occ = occ.reshape(-1)
        self.origin = np.asarray(origin, np.float32)
        self.vs = float(np.float32(voxel_size))
        self.dims = tuple(dims)
        self.dtype = dtype
        self.walk = _Walk(self.origin, self.vs, dims, occ.device, dtype)

    def nearest(self, o, d, t_min, t_max):
        """(t, cell lin) of the nearest hit; inf, -1 on a miss."""
        def visit(ids, lin, t0, t1):
            hit = self.occ[lin] & (t1 > torch.clamp(t0, min=0.0)) \
                & (t0 >= t_min) & (t0 <= t_max[ids])
            return hit, (t0[hit], lin[hit])

        res = self.walk.run(o, d, t_max, visit)
        return _gather(res, o.shape[0], ((INF, o.dtype), (-1, torch.int64)),
                       o.device)

    def occluded(self, o, d, t_min, t_max):
        t, _ = self.nearest(o, d, t_min, t_max)
        return torch.isfinite(t)

    def surface(self, o, d, t, lin):
        """(hit, world position, normal, is_voxel) of a nearest-hit trace."""
        hit = lin >= 0
        pos = o + d * torch.where(hit, t, torch.ones_like(t))[:, None]
        nx, ny = self.dims[0], self.dims[1]
        c = torch.clamp(lin, min=0)
        idx = torch.stack([c % nx, (c // nx) % ny, c // (nx * ny)], 1)
        org = torch.as_tensor(self.origin, device=o.device).to(o.dtype)
        center = org + (idx.to(o.dtype) + 0.5) * self.vs
        rel = pos - center
        rel = rel / torch.linalg.vector_norm(rel, dim=1, keepdim=True)
        a = rel.abs()
        m = a.amax(dim=1)
        is_x = m == a[:, 0]
        is_y = ~is_x & (m == a[:, 1])
        is_z = ~is_x & ~is_y
        zero = torch.zeros_like(m)
        normal = torch.stack([torch.where(is_x, torch.sign(rel[:, 0]), zero),
                              torch.where(is_y, torch.sign(rel[:, 1]), zero),
                              torch.where(is_z, torch.sign(rel[:, 2]), zero)],
                             1)
        return hit, pos, normal, torch.ones_like(hit)


class TriangleScene:
    """The triangle scene: the mesh's triangles binned by bounding box into
    a uniform grid of `res` cells on the longest axis (the reference's own
    structure; the program's triangle accel is not read)."""

    def __init__(self, v, f, res, device, dtype=torch.float64):
        tri = torch.as_tensor(np.asarray(v, np.float32)[np.asarray(f)],
                              device=device).to(dtype)
        self.v0, self.v1, self.v2 = tri[:, 0], tri[:, 1], tri[:, 2]
        e1, e2 = self.v1 - self.v0, self.v2 - self.v0
        n = torch.linalg.cross(e1, e2)
        nn = torch.linalg.vector_norm(n, dim=1, keepdim=True)
        self.normal = torch.where(nn > 0, n / torch.clamp(nn, min=1e-300), n)
        self.dtype = dtype
        vf = np.asarray(v, np.float64)
        lo, hi = vf.min(axis=0), vf.max(axis=0)
        cell = float(max(hi - lo)) / res
        # half a cell of margin, so no triangle sits on the grid's faces
        lo = lo - 0.5 * cell
        dims = tuple(int(x) for x in np.ceil((hi + 0.5 * cell - lo) / cell))
        self.walk = _Walk(lo, cell, dims, device, dtype)
        bmin = torch.minimum(self.v0, torch.minimum(self.v1, self.v2))
        bmax = torch.maximum(self.v0, torch.maximum(self.v1, self.v2))
        lo_t = torch.as_tensor(lo, device=device, dtype=torch.float64)
        dims_t = torch.tensor(dims, device=device)
        # conservative: each box widened by a millionth of a cell
        c0 = torch.floor((bmin.double() - lo_t) / cell - 1e-6).long()
        c1 = torch.floor((bmax.double() - lo_t) / cell + 1e-6).long()
        c0 = torch.minimum(torch.clamp(c0, min=0), dims_t - 1)
        c1 = torch.minimum(torch.clamp(c1, min=0), dims_t - 1)
        w = c1 - c0 + 1
        cap = w[:, 0] * w[:, 1] * w[:, 2]
        tid = torch.repeat_interleave(torch.arange(len(cap), device=device),
                                      cap)
        first = torch.cumsum(cap, 0) - cap
        k = torch.arange(tid.shape[0], device=device) - first[tid]
        cx = c0[tid, 0] + k % w[tid, 0]
        cy = c0[tid, 1] + (k // w[tid, 0]) % w[tid, 1]
        cz = c0[tid, 2] + k // (w[tid, 0] * w[tid, 1])
        lin = cx + dims[0] * (cy + dims[1] * cz)
        order = torch.argsort(lin * len(cap) + tid)
        self.cell_tris = tid[order]
        counts = torch.bincount(lin, minlength=dims[0] * dims[1] * dims[2])
        self.count = counts
        self.first = torch.cumsum(counts, 0) - counts

    def _pairs(self, ids, lin):
        """(ray slot, triangle) pairs of the listed cells, in chunks."""
        cnt = self.count[lin]
        rows = torch.nonzero(cnt).squeeze(1)
        if not rows.numel():
            return
        cnt = cnt[rows]
        cum = torch.cumsum(cnt, 0)
        cum_h = cum.cpu().numpy()
        r0 = 0
        while r0 < len(rows):
            base = int(cum_h[r0 - 1]) if r0 else 0
            r1 = max(int(np.searchsorted(cum_h, base + PAIRS, side="right")),
                     r0 + 1)
            sub = rows[r0:r1]
            c = cnt[r0:r1]
            slot = torch.repeat_interleave(sub, c)
            off = torch.cumsum(c, 0) - c
            k = torch.arange(slot.shape[0], device=lin.device) \
                - torch.repeat_interleave(off, c)
            tri = self.cell_tris[self.first[lin[slot]] + k]
            yield slot, tri
            r0 = r1

    def _test(self, o, d, tri, t_min, t_max):
        """Moller-Trumbore, t or inf."""
        a, b, c = self.v0[tri], self.v1[tri], self.v2[tri]
        e1, e2 = b - a, c - a
        p = torch.linalg.cross(d, e2)
        det = (e1 * p).sum(1)
        ok = det.abs() > 1e-8
        inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
        s = o - a
        u = (s * p).sum(1) * inv
        q = torch.linalg.cross(s, e1)
        w = (d * q).sum(1) * inv
        t = (e2 * q).sum(1) * inv
        hit = ok & (u >= 0) & (w >= 0) & (u + w <= 1) & (t > t_min) \
            & (t < t_max)
        return torch.where(hit, t, torch.full_like(t, INF))

    def _trace(self, o, d, t_min, t_max, any_hit):
        n, dev = o.shape[0], o.device

        def visit(ids, lin, t0, t1):
            best = torch.full((ids.shape[0],), INF, dtype=o.dtype,
                              device=dev)
            found = []
            for slot, tri in self._pairs(ids, lin):
                r = ids[slot]
                t = self._test(o[r], d[r], tri, t_min, t_max[r])
                best.scatter_reduce_(0, slot, t, "amin")
                found.append((slot, tri, t))
            done = torch.isfinite(best)
            if not any_hit:
                # a hit counts in the cell that holds it: one beyond the
                # cell is found again, in its own cell, by a triangle
                # listed there
                done &= best <= t1 + 1e-9 * (1.0 + t1.abs())
            # the lowest triangle id among those at the nearest t
            tid = torch.full((ids.shape[0],), NO_ID, dtype=torch.int64,
                             device=dev)
            for slot, tri, t in found:
                m = torch.isfinite(t) & (t == best[slot])
                tid.scatter_reduce_(0, slot[m], tri[m], "amin")
            return done, (best[done], tid[done])

        res = self.walk.run(o, d, t_max, visit)
        return _gather(res, n, ((INF, o.dtype), (-1, torch.int64)), dev)

    def nearest(self, o, d, t_min, t_max):
        return self._trace(o, d, t_min, t_max, False)

    def occluded(self, o, d, t_min, t_max):
        t, _ = self._trace(o, d, t_min, t_max, True)
        return torch.isfinite(t)

    def surface(self, o, d, t, tri):
        hit = tri >= 0
        pos = o + d * torch.where(hit, t, torch.ones_like(t))[:, None]
        normal = self.normal[torch.clamp(tri, min=0)]
        return hit, pos, normal, torch.zeros_like(hit)


# ------------------------------------------------------------------ shading

def _dot(a, b):
    return (a * b).sum(1)


def _primary(scene, view_inv, proj_inv, width, height, shading, device):
    """The nearest-hit pass and the light terms of a frame."""
    dtype = scene.dtype
    o, d = camera_rays(view_inv, proj_inv, width, height, device, dtype)
    n = o.shape[0]
    t_max = torch.full((n,), T_MAX, dtype=dtype, device=device)
    t, hid = scene.nearest(o, d, T_MIN, t_max)
    hit, pos, normal, is_vox = scene.surface(o, d, t, hid)
    light = shading["light"]
    if light["type"] != 0:
        raise ValueError("the reference shades a point light (type 0) only")
    ldir = torch.tensor(light["position"], dtype=dtype, device=device) - pos
    dist = torch.linalg.vector_norm(ldir, dim=1)
    l_vec = ldir / dist[:, None]
    inten = light["intensity"] / (dist * dist)
    dot_nl = _dot(normal, l_vec)
    facing = hit & (dot_nl > 0)
    return dict(d=d, hit=hit, pos=pos, normal=normal, is_vox=is_vox,
                l_vec=l_vec, dist=dist, inten=inten, dot_nl=dot_nl,
                facing=facing)


def admitted(scene, view_inv, proj_inv, width, height, shading, device):
    """The shadow rays of a frame: its pixels that hit something facing
    the light."""
    p = _primary(scene, view_inv, proj_inv, width, height, shading, device)
    return int(p["facing"].sum())


def _linear(row):
    """sRGB -> linear of a material row's colours (ambient, diffuse,
    specular ** 2.2), as meshes' materials load (hello_vulkan.cpp:204-208);
    the voxel material is taken raw."""
    out = list(row)
    out[0:9] = [float(x) ** 2.2 for x in out[0:9]]
    return out


def render(scene, view_inv, proj_inv, width, height, shading, device):
    """(H, W, 4) gamma-corrected frame of `scene` (VoxelScene or
    TriangleScene).  shading: the configuration's light, material and
    clear colour.  The rays, walks and hit points are in the scene's
    dtype; the shading in that dtype or float32, whichever is wider, so
    the bfloat16 control rounds the geometry and not the colours."""
    p = _primary(scene, view_inv, proj_inv, width, height, shading, device)
    dtype = torch.promote_types(scene.dtype, torch.float32)
    p = {k: v.to(dtype) if v.is_floating_point() else v
         for k, v in p.items()}
    hit, facing, normal, l_vec = p["hit"], p["facing"], p["normal"], \
        p["l_vec"]
    mat_v = torch.tensor(shading["material"], dtype=dtype, device=device)
    mat_t = torch.tensor(_linear(shading["material"]), dtype=dtype,
                         device=device)
    mat = torch.where(p["is_vox"][:, None], mat_v, mat_t)
    shadowed = torch.zeros_like(facing)
    adm = torch.nonzero(facing).squeeze(1)
    if adm.numel():
        lo = scene.dtype
        shadowed[adm] = scene.occluded(p["pos"][adm].to(lo),
                                       l_vec[adm].to(lo), T_MIN,
                                       p["dist"][adm].to(lo))
    lit = facing & ~shadowed
    diffuse = mat[:, 3:6] * torch.clamp(p["dot_nl"], min=0.0)[:, None]
    diffuse = diffuse + torch.where(mat[:, 18:19] >= 1, mat[:, 0:3],
                                    torch.zeros_like(diffuse))
    shin = torch.clamp(mat[:, 15], min=4.0)
    d = p["d"]
    view = -d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    refl = -l_vec - 2.0 * _dot(normal, -l_vec)[:, None] * normal
    spec = (2.0 + shin) / (2.0 * math.pi) \
        * torch.clamp(_dot(view, refl), min=0.0) ** shin
    spec = mat[:, 6:9] * spec[:, None]
    spec = torch.where((mat[:, 18:19] >= 2) & lit[:, None], spec,
                       torch.zeros_like(spec))
    att = torch.where(p["is_vox"], torch.where(lit, 1.0, 0.3),
                      torch.where(facing & shadowed, 0.3, 1.0)).to(dtype)
    color = (p["inten"] * att)[:, None] * (diffuse + spec)
    clear = torch.tensor(shading["clear_color"][:3], dtype=dtype,
                         device=device)
    color = torch.where(hit[:, None], color, clear * 0.8)
    rgba = torch.cat([color, torch.ones_like(color[:, :1])], 1)
    img = torch.pow(torch.clamp(rgba, min=0.0), 1.0 / 2.2)
    return img.reshape(height, width, 4)
