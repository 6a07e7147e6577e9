"""Trusted NumPy reference renderer.

A direct, slow transcription of the reference's per-pixel contract
(raytrace.rgen / raytrace.rint / raytrace.rchit / raytrace2.rchit /
raytrace.rmiss / wavefront.glsl / post.frag) used to pixel-gate the
render pipeline.  Brute force: every ray tests every AABB and every
triangle.  Copied from voxelray_tpu/oracle_render.py (numpy only).

Scope: voxel AABBs + triangle models, point/directional light, shadow
rays, texture-free materials (texture modulation is exercised by separate
sampler unit tests).
"""
from __future__ import annotations

import numpy as np

__all__ = ["oracle_render"]


def _slab_t(aabbs, o, d):
    """Reference slab test per AABB: t0 where hit else -1
    (raytrace.rint:46-56)."""
    inv = np.float32(1.0) / d
    tbot = inv * (aabbs[:, 0:3] - o)
    ttop = inv * (aabbs[:, 3:6] - o)
    tmin = np.minimum(tbot, ttop)
    tmax = np.maximum(tbot, ttop)
    t0 = tmin.max(axis=1)
    t1 = tmax.min(axis=1)
    return np.where(t1 > np.maximum(t0, 0.0), t0, -1.0)


def _nearest_voxel(aabbs, o, d, t_min, t_max):
    t0 = _slab_t(aabbs, o, d)
    ok = (t0 > 0.0) & (t0 >= t_min) & (t0 <= t_max)
    t0 = np.where(ok, t0, np.inf)
    i = int(np.argmin(t0))
    return (float(t0[i]), i) if np.isfinite(t0[i]) else (np.inf, -1)


def _nearest_triangle(v0, v1, v2, o, d, t_min, t_max):
    eps = np.float32(1e-8)
    e1 = v1 - v0
    e2 = v2 - v0
    p = np.cross(np.broadcast_to(d, e2.shape), e2)
    det = (e1 * p).sum(1)
    ok = np.abs(det) > eps
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    s = o - v0
    u = (s * p).sum(1) * inv
    q = np.cross(s, e1)
    v = (np.broadcast_to(d, q.shape) * q).sum(1) * inv
    t = (e2 * q).sum(1) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min) & (t < t_max)
    t = np.where(hit, t, np.inf)
    i = int(np.argmin(t))
    if not np.isfinite(t[i]):
        return np.inf, -1, 0.0, 0.0
    return float(t[i]), i, float(u[i]), float(v[i])


def _diffuse(mat, l, n):
    dot_nl = max(float(np.dot(n, l)), 0.0)
    c = mat[3:6] * dot_nl
    if mat[18] >= 1:
        c = c + mat[0:3]
    return c


def _specular(mat, view_dir, l, n):
    if mat[18] < 2:
        return np.zeros(3, np.float32)
    shin = max(float(mat[15]), 4.0)
    energy = (2.0 + shin) / (2.0 * np.pi)
    v = -view_dir / np.linalg.norm(view_dir)
    r = -l - 2.0 * np.dot(n, -l) * n
    spec = energy * max(float(np.dot(v, r)), 0.0) ** shin
    return mat[6:9] * spec


def oracle_render(width, height, view_inv, proj_inv, aabbs, vox_material,
                  tri=None, tri_normals=None, tri_materials=None,
                  light_position=(10.0, 55.0, 8.0), light_intensity=1000.0,
                  light_type=0, clear_color=(1.0, 1.0, 1.0, 1.0)):
    """(H, W, 4) float32 gamma-corrected framebuffer.

    tri: optional (F, 3, 3) triangle vertices with per-corner normals
    (F, 3, 3) and per-triangle material rows (F, 20).
    """
    aabbs = np.asarray(aabbs, np.float32)
    img = np.zeros((height, width, 4), np.float32)
    lp = np.asarray(light_position, np.float32)
    clear = np.asarray(clear_color, np.float32)
    t_min, t_max = np.float32(0.001), np.float32(10000.0)

    has_tri = tri is not None and len(tri)
    if has_tri:
        tv0, tv1, tv2 = tri[:, 0], tri[:, 1], tri[:, 2]

    def any_occluder(o, d, lo, hi):
        if len(aabbs):
            t0 = _slab_t(aabbs, o, d)
            if np.any((t0 > 0) & (t0 >= lo) & (t0 <= hi)):
                return True
        if has_tri:
            t, i, _, _ = _nearest_triangle(tv0, tv1, tv2, o, d, lo, hi)
            if np.isfinite(t):
                return True
        return False

    for py in range(height):
        for px in range(width):
            # raygen (raytrace.rgen:41-47)
            dx = (px + 0.5) / width * 2.0 - 1.0
            dy = (py + 0.5) / height * 2.0 - 1.0
            origin = view_inv[:3, 3].astype(np.float32)
            target = proj_inv @ np.asarray([dx, dy, 1.0, 1.0], np.float32)
            tn = target[:3] / np.linalg.norm(target[:3])
            direction = (view_inv[:3, :3] @ tn).astype(np.float32)

            t_vox, vi = (_nearest_voxel(aabbs, origin, direction, t_min,
                                        t_max) if len(aabbs)
                         else (np.inf, -1))
            if has_tri:
                t_tri, ti, bu, bv = _nearest_triangle(
                    tv0, tv1, tv2, origin, direction, t_min, t_max)
            else:
                t_tri, ti = np.inf, -1

            if not np.isfinite(min(t_vox, t_tri)):
                img[py, px, :3] = clear[:3] * np.float32(0.8)
                img[py, px, 3] = 1.0
                continue

            voxel = t_vox < t_tri
            t_hit = t_vox if voxel else t_tri
            world = origin + direction * np.float32(t_hit)

            if voxel:
                box = aabbs[vi]
                center = (box[0:3] + box[3:6]) * 0.5
                n = world - center
                n = n / np.linalg.norm(n)
                a = np.abs(n)
                if a[0] >= a[1] and a[0] >= a[2]:
                    n = np.asarray([np.sign(n[0]), 0, 0], np.float32)
                elif a[1] >= a[2]:
                    n = np.asarray([0, np.sign(n[1]), 0], np.float32)
                else:
                    n = np.asarray([0, 0, np.sign(n[2])], np.float32)
                mat = np.asarray(vox_material, np.float32)
            else:
                nrm = tri_normals[ti]
                n = nrm[0] * (1 - bu - bv) + nrm[1] * bu + nrm[2] * bv
                n = n / np.linalg.norm(n)
                mat = np.asarray(tri_materials[ti], np.float32)

            # light (raytrace.rchit:77-91)
            if light_type == 0:
                ldir = lp - world
                dist = float(np.linalg.norm(ldir))
                l = ldir / dist
                inten = light_intensity / (dist * dist)
            else:
                l = lp / np.linalg.norm(lp)
                dist = 100000.0
                inten = light_intensity

            diffuse = _diffuse(mat, l, n)
            spec = np.zeros(3, np.float32)
            att = 0.3 if voxel else 1.0
            if float(np.dot(n, l)) > 0:
                shadowed = any_occluder(world, l, t_min, dist)
                if shadowed:
                    att = 0.3
                else:
                    att = 1.0
                    spec = _specular(mat, direction, l, n)

            img[py, px, :3] = inten * att * (diffuse + spec)
            img[py, px, 3] = 1.0

    return np.power(np.clip(img, 0.0, None), np.float32(1.0 / 2.2))
