"""Software rasterizer — the classic-pipeline fallback.

Counterpart of voxelray_tpu/render/raster.py.  The reference can toggle
from ray tracing to a raster pipeline (main.cpp:241-247): vertex
transform by viewProj (vert_shader.vert:56-66) then per-pixel Lambert +
specular with the same material model but NO shadow rays
(frag_shader.frag:56-99).  Only OBJ instances are drawn — the implicit
AABB instance is excluded (hello_vulkan.cpp:417-428), so voxels don't
appear in raster mode; same here.

Coverage: perspective-correct barycentrics over (pixels x triangle
chunks of `chunk`) with a z-buffer (depth in Vulkan ZO [0, 1]).  The
JAX package's order is kept exactly: within a chunk the nearest covering
triangle wins (argmin, so the first index on equal z), and it replaces
the pixel only if strictly nearer than the z-buffer (the earlier chunk
wins a tie).  A pixel's colour depends only on its final winner and that
winner's barycentrics, so the buffers carry (z, triangle, barycentrics)
through the chunks and the pixels are shaded once at the end, with the
expressions the JAX package evaluates per chunk.  Background is the
clear colour (the render-pass clear), and the shared gamma post pass
applies on top (post.frag): no 0.8 dimming, that's the ray miss shader
only.  Textures filter trilinearly across the mip chain, the LOD
being tri_lod plus log2 of the pixel footprint at the hit distance.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.scene import Light, Scene
from . import shading
from .camera import Camera
from .pipeline import _sample_texture

__all__ = ["rasterize_image", "rasterize_scene"]


def _matmul4(a, b):
    """float32 4x4 product with each sum taken left to right."""
    out = np.zeros((4, 4), np.float32)
    for i in range(4):
        for j in range(4):
            acc = a[i, 0] * b[0, j]
            for k in range(1, 4):
                acc = np.float32(acc + a[i, k] * b[k, j])
            out[i, j] = acc
    return out


def _project(vp, pos):
    """World -> (ndc (F, 3), clip w (F,)) with the (4, 4) viewProj."""
    m = torch.as_tensor(vp, device=pos.device)
    x, y, z = pos.unbind(-1)
    clip = [((m[i, 0] * x + m[i, 1] * y) + m[i, 2] * z) + m[i, 3]
            for i in range(4)]
    w = clip[3]
    w_safe = torch.where(w.abs() > 1e-20, w, torch.full_like(w, 1e-20))
    return torch.stack([c / w_safe for c in clip[:3]], dim=-1), w


def _edge(ax, ay, bx, by, x, y):
    return (x - ax) * (by - ay) - (y - ay) * (bx - ax)


def _norm(v):
    return torch.sqrt(shading.dot3(v, v))


def rasterize_image(scene: Scene, view, proj, eye, light: Light = Light(),
                    clear_color=(1.0, 1.0, 1.0, 1.0), *, width, height,
                    chunk=64):
    """(H, W, 4) float32 framebuffer on the scene's device, gamma
    applied.  view / proj: the camera's (4, 4) float32 matrices; eye: the
    camera position."""
    dev = scene.device
    f32 = torch.float32
    bg = torch.as_tensor(np.asarray(clear_color, np.float32)[:3],
                         device=dev)
    frame = bg.expand(height, width, 3)
    n = scene.n_triangles
    if n == 0:
        rgba = torch.cat([frame, torch.ones((height, width, 1), device=dev)],
                         dim=-1)
        return shading.gamma_post(rgba)
    view = np.asarray(view, np.float32)
    proj = np.asarray(proj, np.float32)
    vp = _matmul4(proj, view)

    sy, sx = torch.meshgrid(torch.arange(height, dtype=f32, device=dev) + 0.5,
                            torch.arange(width, dtype=f32, device=dev) + 0.5,
                            indexing="ij")
    x, y = sx[..., None], sy[..., None]                     # (H, W, 1)

    ndc, w = zip(*(_project(vp, v) for v in
                   (scene.tri_v0, scene.tri_v1, scene.tri_v2)))
    sxs = [(q[:, 0] + 1.0) * 0.5 * width for q in ndc]
    sys_ = [(q[:, 1] + 1.0) * 0.5 * height for q in ndc]
    zs = [q[:, 2] for q in ndc]

    zbuf = torch.ones((height, width), device=dev)
    win = torch.full((height, width), -1, dtype=torch.int64, device=dev)
    bary = torch.zeros((3, height, width), device=dev)
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(c0 + chunk, n))
        ax, bx, cx = (q[sl] for q in sxs)
        ay, by, cy = (q[sl] for q in sys_)
        e0 = _edge(ax, ay, bx, by, x, y)                    # (H, W, c)
        e1 = _edge(bx, by, cx, cy, x, y)
        e2 = _edge(cx, cy, ax, ay, x, y)
        area = _edge(ax, ay, bx, by, cx, cy)                # (c,)
        sgn = torch.sign(area)
        big = area.abs() > 1e-12
        ok_tri = big & (w[0][sl] > 0) & (w[1][sl] > 0) & (w[2][sl] > 0)
        inside = (e0 * sgn >= 0) & (e1 * sgn >= 0) & (e2 * sgn >= 0) \
            & ok_tri
        inv_area = 1.0 / torch.where(big, area, torch.ones_like(area))
        l0, l1, l2 = e1 * inv_area, e2 * inv_area, e0 * inv_area
        del e0, e1, e2
        z = (l0 * zs[0][sl] + l1 * zs[1][sl]) + l2 * zs[2][sl]
        inside &= (z >= 0.0) & (z <= 1.0)
        z = torch.where(inside, z, torch.full_like(z, 2.0))
        del inside
        best = torch.argmin(z, dim=-1, keepdim=True)        # (H, W, 1)
        zb = z.gather(-1, best)[..., 0]
        del z
        visible = zb < zbuf
        zbuf = torch.where(visible, zb, zbuf)
        win = torch.where(visible, best[..., 0] + c0, win)
        for k, lk in enumerate((l0, l1, l2)):
            bary[k] = torch.where(visible, lk.gather(-1, best)[..., 0],
                                  bary[k])
        del l0, l1, l2

    # perspective-correct interpolation and shading of each pixel's winner
    covered = win >= 0
    tid = torch.clamp(win, min=0)
    pw = [bary[k] * (1.0 / w[k][tid]) for k in range(3)]
    total = (pw[0] + pw[1]) + pw[2]
    pw = [(p / total)[..., None] for p in pw]

    def lerp3(a, b, c):
        return (a[tid] * pw[0] + b[tid] * pw[1]) + c[tid] * pw[2]

    world = lerp3(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    nrm = lerp3(scene.tri_n0, scene.tri_n1, scene.tri_n2)
    nrm = nrm / torch.clamp(_norm(nrm), min=1e-20)
    uv = lerp3(scene.tri_uv0, scene.tri_uv1, scene.tri_uv2)
    mat = scene.materials[scene.tri_mat[tid].long()]
    l_vec, intensity, _ = shading.light_terms(world, light.position,
                                              light.intensity, light.type)
    diffuse = shading.compute_diffuse(mat, l_vec, nrm)
    view_dir = world - torch.as_tensor(np.asarray(eye, np.float32),
                                       device=dev)
    dist = _norm(view_dir)
    view_dir = view_dir / torch.clamp(dist, min=1e-20)
    # the raster sampler is derivative-driven (maxLod = FLT_MAX):
    # approximated by the pixel footprint at the hit distance
    spread = float(np.float32(2.0) / (np.abs(proj[1, 1])
                                      * np.float32(height)))
    cosv = shading.dot3(nrm, view_dir)[..., 0].abs()
    footprint = dist[..., 0] * spread / torch.clamp(cosv, min=1e-3)
    lod = scene.tri_lod[tid] + torch.log2(torch.clamp(footprint, min=1e-20))
    diffuse = diffuse * _sample_texture(scene.textures, scene.tex_meta,
                                        scene.tri_tex[tid], uv, lod)
    specular = shading.compute_specular(mat, view_dir, l_vec, nrm)
    color = intensity[..., None] * (diffuse + specular)
    frame = torch.where(covered[..., None], color, frame)
    rgba = torch.cat([frame, torch.ones((height, width, 1), device=dev)],
                     dim=-1)
    return shading.gamma_post(rgba)


def rasterize_scene(scene: Scene, camera: Camera = Camera(), *, width=1280,
                    height=720, light: Light = Light(),
                    clear_color=(1.0, 1.0, 1.0, 1.0)):
    """Camera dataclass in, raster frame out."""
    view, proj, _, _ = camera.matrices(width, height)
    return rasterize_image(scene, view, proj, camera.eye, light,
                           clear_color, width=width, height=height)
