"""Ray primitives: camera ray generation, the slab test, triangles.

  make_camera_rays — the raygen reconstruction from inverse matrices
                     (raytrace.rgen:41-47)
  hit_aabb         — branchless slab test, hit iff t1 > max(t0, 0),
                     reporting t0 (raytrace.rint:46-56); the renderer
                     additionally requires tMin <= t0 <= tMax
  hit_triangles    — Moller-Trumbore with barycentrics, the software
                     equivalent of Vulkan's triangle intersector

Counterpart of voxelray_tpu/ops/intersect.py.  The matrix-vector products
of make_camera_rays are written out as explicit left-to-right sums, so
the rays do not depend on a BLAS or TF32 setting; they agree with the
JAX package's einsum to about one ulp.
"""
from __future__ import annotations

import numpy as np
import torch

from .geometry import div_scalar

__all__ = ["make_camera_rays", "hit_aabb", "hit_triangles", "TMIN",
           "TMAX"]

TMIN = np.float32(0.001)    # raytrace.rgen:50
TMAX = np.float32(10000.0)  # raytrace.rgen:51


def _matvec(m, v):
    """m (R, C) float32 tensor times a list of C (...)-tensors, summed
    left to right -> R tensors."""
    rows = []
    for i in range(m.shape[0]):
        acc = m[i, 0] * v[0]
        for j in range(1, len(v)):
            acc = acc + m[i, j] * v[j]
        rows.append(acc)
    return rows


def make_camera_rays(width: int, height: int, view_inv, proj_inv,
                     device="cpu"):
    """Per-pixel rays: origins (H, W, 3), directions (H, W, 3) float32.

    Pixel (0, 0) is the top-left launch id; the Y-flipped projection
    makes +d.y point down exactly as in the Vulkan render.
    """
    vi = torch.as_tensor(np.asarray(view_inv, np.float32), device=device)
    pi = torch.as_tensor(np.asarray(proj_inv, np.float32), device=device)
    f32 = torch.float32
    px = div_scalar(torch.arange(width, dtype=f32, device=device) + 0.5,
                    width) * 2.0 - 1.0
    py = div_scalar(torch.arange(height, dtype=f32, device=device) + 0.5,
                    height) * 2.0 - 1.0
    dy, dx = torch.meshgrid(py, px, indexing="ij")      # (H, W)
    one = torch.ones_like(dx)
    tx, ty, tz = _matvec(pi[:3], [dx, dy, one, one])
    norm = torch.sqrt((tx * tx + ty * ty) + tz * tz)
    tn = [tx / norm, ty / norm, tz / norm]
    direction = torch.stack(_matvec(vi[:3, :3], tn), dim=-1)
    origins = vi[:3, 3].expand(direction.shape)
    return origins, direction


def hit_aabb(aabb_min, aabb_max, origin, direction):
    """Slab test; returns t0 where hit, else -1.0 (raytrace.rint:46-56).

    Shapes broadcast; the caller applies the ray-interval clamp.
    """
    inv_dir = 1.0 / direction
    tbot = inv_dir * (aabb_min - origin)
    ttop = inv_dir * (aabb_max - origin)
    tmin = torch.minimum(ttop, tbot)
    tmax = torch.maximum(ttop, tbot)
    t0 = torch.maximum(tmin[..., 0],
                       torch.maximum(tmin[..., 1], tmin[..., 2]))
    t1 = torch.minimum(tmax[..., 0],
                       torch.minimum(tmax[..., 1], tmax[..., 2]))
    return torch.where(t1 > torch.clamp(t0, min=0.0), t0,
                       torch.full_like(t0, -1.0))


def _cross(a, b):
    """Components of a x b, each a list of three tensors (jnp.cross's
    expression per component)."""
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def hit_triangles(origin, direction, v0, v1, v2, t_min=TMIN, t_max=TMAX):
    """Moller-Trumbore; returns (t, u, v) with t = inf on miss.

    origin/direction: (..., 3); v0/v1/v2: (..., 3) broadcastable; t_min
    and t_max scalars or tensors broadcastable to the batch.  Backface
    culling off (the reference builds its BLAS without culling flags);
    degenerate triangles miss.  The expressions of voxelray_tpu's
    hit_triangles, with three-term sums taken left to right.
    """
    o, d = origin.unbind(-1), direction.unbind(-1)
    a, b, c = v0.unbind(-1), v1.unbind(-1), v2.unbind(-1)
    e1 = [b[i] - a[i] for i in range(3)]
    e2 = [c[i] - a[i] for i in range(3)]
    p = _cross(d, e2)
    det = _dot(e1, p)
    ok = torch.abs(det) > 1e-8
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    s = [o[i] - a[i] for i in range(3)]
    u = _dot(s, p) * inv_det
    q = _cross(s, e1)
    v = _dot(d, q) * inv_det
    t = _dot(e2, q) * inv_det
    if not torch.is_tensor(t_min):
        t_min = float(np.float32(t_min))
    if not torch.is_tensor(t_max):
        t_max = float(np.float32(t_max))
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) \
        & (t < t_max)
    return torch.where(hit, t, torch.full_like(t, float("inf"))), u, v
