"""The frame glue's kernels (csrc/frame_shade.cu) and their wrappers.

New kernels: the JAX package runs the frame's per-pixel glue as one XLA
jit (voxelray_tpu/render/pipeline.py), with no Pallas kernel.  Here:

  camera_rays_cuda   the frame's camera rays, (n, 3) origins and
                     directions in 8x128 tile order or row-major
  hit_surface_cuda   the closest-hit terms of the primary traces: the
                     shadow query (world_pos, l_vec, light_dist, the admit
                     mask hit & facing) and a record a ray for shade_post
  shade_post_cuda    the shade stage from the record and the shadow pass's
                     occlusion: the gamma-corrected (H, W, 4) framebuffer
                     in pixel order, or linear RGB in ray order

Their plain version is render/pipeline.py's PyTorch glue (make_camera_rays
and _tile_rays, surface_terms, the shade stage, gamma_post), which the
pipeline runs on CPU tensors; it sends CUDA tensors here, and raises on
any other device.  The kernels give the plain version's values bit for
bit, but those that pass through pow (the specular power, gamma), within
2 ulp.

Each frame's constants (matrices, light, clear colour) go to the kernel
by value, so a call makes no tensor from a host value and no host sync.
The host side is kept short: a call checks its tensors and allocates
only its outputs, and _build.launch calls the entry point, bound once a
process.
rays_args, surface_args and shade_args build a launch's argument block on
any device, so the host build of the kernels (tests/) runs the same
blocks.  Each launch adds 1 to the counter `launches.<kernel>` and its
rays to `rays.<kernel>` (utils/trace.py).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ...utils import trace
from ._build import F, I, P, fields, launch, need, on_cuda

__all__ = ["camera_rays_cuda", "hit_surface_cuda", "shade_post_cuda",
           "rays_args", "rays_camera", "surface_args", "shade_args",
           "Tables", "HitSurface",
           "RaysArgs", "SurfaceArgs", "ShadeArgs", "RECORD", "GAMMA"]

# floats a ray's record holds: normal, flags word; diffuse, intensity
RECORD = 8
# shading.gamma_post's exponent
GAMMA = float(np.float32(1.0 / 2.2))
_TILE_H, _TILE_W = 8, 128
_LIGHT_POINT = 0
MAT_ROW = 20


class RaysArgs(ctypes.Structure):
    """csrc/frame_shade.cu's RaysArgs."""
    SIZES = ("frame_shade_sizes", 0)
    _fields_ = fields((F * 12, "vi"), (F * 16, "pi"),
                      (I, "width height tiled n"), (P, "origins dirs"))


class SurfaceArgs(ctypes.Structure):
    """csrc/frame_shade.cu's SurfaceArgs."""
    SIZES = ("frame_shade_sizes", 1)
    _fields_ = fields(
        (P, "o d t_vox vox_id t_tri tri_id bu bv tri_n0 tri_n1 tri_n2 "
             "tri_uv0 tri_uv1 tri_uv2 tri_mat tri_tex materials "
             "voxel_material textures tex_meta boxes grid_origin"),
        (F * 3, "org"), (F, "vs"),
        (I, "nx ny has_tri vox_normal n_layers tex_h tex_w tex_levels"),
        (F * 3, "light"), (F, "intensity"), (I, "light_type n"),
        (P, "world_pos l_vec light_dist admit rec"))


class ShadeArgs(ctypes.Structure):
    """csrc/frame_shade.cu's ShadeArgs."""
    SIZES = ("frame_shade_sizes", 2)
    _fields_ = fields((P, "rec d l_vec occluded materials voxel_material"),
                      (F * 3, "clear"), (F, "gamma"),
                      (I, "n width height tiled image"), (P, "out"))


class Tables(NamedTuple):
    """What hit_surface reads besides the traces, as plain tensors and
    numbers (render/pipeline.py unpacks them from its scene)."""

    materials: torch.Tensor        # (M, 20) float32 material rows
    voxel_material: torch.Tensor   # (20,) float32, the voxels' row
    # the triangles' rows, None without triangles: tri_n the three vertex
    # normals (F, 3), tri_uv the three UVs (F, 2), float32; tri_mat,
    # tri_tex (F,) int32; the (T, TH, TW, 3) float32 texture stack and
    # its (T, L, 4) int32 level table
    tri_n: tuple | None = None
    tri_uv: tuple | None = None
    tri_mat: torch.Tensor | None = None
    tri_tex: torch.Tensor | None = None
    textures: torch.Tensor | None = None
    tex_meta: torch.Tensor | None = None
    # a voxel hit's normal is shading.cube_normal about the centre of
    # box vox_id of boxes (NB, 6) float32, or else of cell vox_id of the
    # grid (origin, (nx, ny, nz), voxel_size), origin a (3,) float32
    # tensor on the rays' device or three numbers; both None: no voxel
    # geometry
    boxes: torch.Tensor | None = None
    grid: tuple | None = None


class HitSurface(NamedTuple):
    """hit_surface_cuda's outputs, in the rays' batch shape: the shadow
    query and the record shade_post_cuda reads."""

    world_pos: torch.Tensor    # (..., 3) hit point (o + d * 1 on a miss)
    l_vec: torch.Tensor        # (..., 3) unit vector toward the light
    light_dist: torch.Tensor   # (...) shadow-ray t_max
    admit: torch.Tensor        # (...) bool: hit & facing
    rec: torch.Tensor          # (n, 8) float32, the per-ray record


def _flat(x, c=None):
    """x as a contiguous (n,) or (n, c) tensor (a copy only when x's
    strides need one)."""
    if x.dim() != (1 if c is None else 2):
        x = x.reshape(-1) if c is None else x.reshape(-1, c)
    return x if x.is_contiguous() else x.contiguous()


def rays_args(width, height, view_inv, proj_inv, tiled, dev):
    """camera_rays' argument block and its outputs (origins, dirs), on
    `dev`."""
    width, height = int(width), int(height)
    n = width * height
    if width <= 0 or height <= 0 or n >= 2 ** 31:
        raise ValueError(f"camera_rays: bad frame {width}x{height}")
    if tiled and (height % _TILE_H or width % _TILE_W):
        raise ValueError(f"camera_rays: {width}x{height} does not tile")
    a = RaysArgs()
    rays_camera(a, view_inv, proj_inv)
    origins = torch.empty((n, 3), dtype=torch.float32, device=dev)
    dirs = torch.empty((n, 3), dtype=torch.float32, device=dev)
    a.width, a.height, a.tiled, a.n = width, height, int(bool(tiled)), n
    a.origins, a.dirs = origins.data_ptr(), dirs.data_ptr()
    return a, origins, dirs


def rays_camera(a, view_inv, proj_inv):
    """Write the camera's inverse matrices (4x4, on the host) into
    camera_rays' block `a`."""
    vi = np.ascontiguousarray(view_inv, np.float32)
    pi = np.ascontiguousarray(proj_inv, np.float32)
    if vi.shape != (4, 4) or pi.shape != (4, 4):
        raise ValueError("camera_rays: the matrices must be 4x4")
    ctypes.memmove(a.vi, vi.ctypes.data, 48)
    ctypes.memmove(a.pi, pi.ctypes.data, 64)


def camera_rays_cuda(width, height, view_inv, proj_inv, tiled, device):
    """make_camera_rays (ops/intersect.py) on the card, in tile order
    (pipeline._tile_rays) when `tiled`: origins, dirs, each (H * W, 3)
    float32 contiguous.  The matrices (4x4, on the host) go by value."""
    dev = torch.device(device)
    on_cuda("camera_rays_cuda", dev)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    args, origins, dirs = rays_args(width, height, view_inv, proj_inv,
                                    tiled, dev)
    launch("camera_rays", args, dev)
    trace.count("rays.camera_rays", args.n)
    return origins, dirs


def surface_args(origins, dirs, t_vox, vox_id, tri, tables: Tables,
                 light_position, light_intensity, light_type):
    """hit_surface's argument block and its outputs (a HitSurface), on
    the rays' device; arguments as hit_surface_cuda's."""
    batch = origins.shape[:-1]
    dev = origins.device
    f32, i32 = torch.float32, torch.int32
    keep = {}

    def ptr(name, x, dtype, shape):
        keep[name] = x      # x may be a copy made for the call
        return need("hit_surface", name, x, dev, dtype, shape)

    o = _flat(origins, 3)
    n = o.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"hit_surface: {n} rays exceed int32 ray indexing")
    if (tri is None) != (tables.tri_n is None):
        raise ValueError("hit_surface: a triangle trace goes with the "
                         "triangles' rows, and only with them")
    a = SurfaceArgs()
    a.o = ptr("origins", o, f32, (n, 3))
    a.d = ptr("dirs", _flat(dirs, 3), f32, (n, 3))
    a.t_vox = ptr("t_vox", _flat(t_vox), f32, (n,))
    if vox_id.dtype != i32:
        vox_id = vox_id.to(i32)
    a.vox_id = ptr("vox_id", _flat(vox_id), i32, (n,))
    if tri is not None:
        t_tri, tri_id, bu, bv = tri
        if tri_id.dtype != i32:
            tri_id = tri_id.to(i32)
        a.t_tri = ptr("t_tri", _flat(t_tri), f32, (n,))
        a.tri_id = ptr("tri_id", _flat(tri_id), i32, (n,))
        a.bu = ptr("u", _flat(bu), f32, (n,))
        a.bv = ptr("v", _flat(bv), f32, (n,))
        nt = tables.tri_mat.shape[0]
        n0, n1, n2 = tables.tri_n
        uv0, uv1, uv2 = tables.tri_uv
        a.tri_n0 = ptr("tri_n0", n0, f32, (nt, 3))
        a.tri_n1 = ptr("tri_n1", n1, f32, (nt, 3))
        a.tri_n2 = ptr("tri_n2", n2, f32, (nt, 3))
        a.tri_uv0 = ptr("tri_uv0", uv0, f32, (nt, 2))
        a.tri_uv1 = ptr("tri_uv1", uv1, f32, (nt, 2))
        a.tri_uv2 = ptr("tri_uv2", uv2, f32, (nt, 2))
        a.tri_mat = ptr("tri_mat", tables.tri_mat, i32, (nt,))
        a.tri_tex = ptr("tri_tex", tables.tri_tex, i32, (nt,))
        tex, meta = tables.textures, tables.tex_meta
        a.n_layers, a.tex_h, a.tex_w = tex.shape[:3]
        a.tex_levels = meta.shape[1]
        a.textures = ptr("textures", tex, f32,
                          (a.n_layers, a.tex_h, a.tex_w, 3))
        a.tex_meta = ptr("tex_meta", meta, i32,
                          (a.n_layers, a.tex_levels, 4))
        a.has_tri = 1
    a.materials = ptr("materials", tables.materials, f32,
                       (tables.materials.shape[0], MAT_ROW))
    a.voxel_material = ptr("voxel_material", tables.voxel_material, f32,
                            (MAT_ROW,))
    if tables.boxes is not None:
        a.boxes = ptr("boxes", tables.boxes, f32,
                       (tables.boxes.shape[0], 6))
        a.vox_normal = 1
    elif tables.grid is not None:
        origin, (a.nx, a.ny, _), vs = tables.grid
        if isinstance(origin, torch.Tensor):
            a.grid_origin = ptr("grid origin", origin, f32, (3,))
        else:
            a.org[:] = np.asarray(origin, np.float32).tolist()
        a.vs = float(np.float32(vs))
        a.vox_normal = 1
    a.light[:] = np.asarray(light_position, np.float32).tolist()
    a.intensity = float(np.float32(light_intensity))
    a.light_type = 0 if int(light_type) == _LIGHT_POINT else 1
    a.n = n
    surf = HitSurface(torch.empty(batch + (3,), dtype=f32, device=o.device),
                      torch.empty(batch + (3,), dtype=f32, device=o.device),
                      torch.empty(batch, dtype=f32, device=o.device),
                      torch.empty(batch, dtype=torch.bool, device=o.device),
                      torch.empty((n, RECORD), dtype=f32, device=o.device))
    a.world_pos, a.l_vec = surf.world_pos.data_ptr(), surf.l_vec.data_ptr()
    a.light_dist, a.admit = surf.light_dist.data_ptr(), surf.admit.data_ptr()
    a.rec = surf.rec.data_ptr()
    a.keep = keep
    return a, surf


def hit_surface_cuda(origins, dirs, t_vox, vox_id, tri, tables: Tables,
                     light_position, light_intensity, light_type):
    """surface_terms (render/pipeline.py) on the card, for the frame's
    shadow query and shading.

    origins, dirs: (..., 3) float32; t_vox, vox_id: the voxel trace
    (float32, int32); tri: the triangle trace (t, id, u, v), given iff
    tables holds the triangles' rows; tables: the rows the hit terms read
    (Tables); the light as shading.light_terms takes it (position,
    intensity, type 0 point, else directional).  Returns a HitSurface in
    the rays' batch shape."""
    on_cuda("hit_surface_cuda", origins.device)
    a, surf = surface_args(origins, dirs, t_vox, vox_id, tri, tables,
                           light_position, light_intensity, light_type)
    launch("hit_surface", a, origins.device)
    trace.count("rays.hit_surface", a.n)
    return surf


def shade_args(surf: HitSurface, dirs, occluded, materials, voxel_material,
               clear_color, frame=None):
    """shade_post's argument block and its output, on the record's
    device; arguments as shade_post_cuda's."""
    rec = surf.rec
    dev = rec.device
    n = rec.shape[0]
    f32 = torch.float32
    keep = {}

    def ptr(name, x, dtype, shape):
        keep[name] = x      # x may be a copy made for the call
        return need("shade_post", name, x, dev, dtype, shape)

    a = ShadeArgs()
    a.rec = ptr("rec", rec, f32, (n, RECORD))
    a.d = ptr("dirs", _flat(dirs, 3), f32, (n, 3))
    a.l_vec = ptr("l_vec", _flat(surf.l_vec, 3), f32, (n, 3))
    if occluded is not None:
        a.occluded = ptr("occluded", _flat(occluded), torch.bool, (n,))
    a.materials = ptr("materials", materials, f32,
                       (materials.shape[0], MAT_ROW))
    a.voxel_material = ptr("voxel_material", voxel_material, f32,
                            (MAT_ROW,))
    a.clear[:] = np.asarray(clear_color, np.float32)[:3].tolist()
    a.gamma = GAMMA
    a.n = n
    if frame is None:
        out = torch.empty(surf.light_dist.shape + (3,), dtype=f32,
                          device=rec.device)
    else:
        height, width, tiled = frame
        if height * width != n or (tiled and (height % _TILE_H
                                              or width % _TILE_W)):
            raise ValueError(f"shade_post: {n} rays do not make a "
                             f"{width}x{height} frame")
        a.width, a.height, a.tiled, a.image = width, height, int(tiled), 1
        out = torch.empty((height, width, 4), dtype=f32, device=rec.device)
    a.out = out.data_ptr()
    a.keep = keep
    return a, out


def shade_post_cuda(surf: HitSurface, dirs, occluded, materials,
                    voxel_material, clear_color, frame=None):
    """The shade stage of render_rays on the card, from hit_surface_cuda's
    record: occluded is the shadow pass's bool occlusion in the rays'
    batch shape, or None without shadow rays (a facing surface is lit);
    materials, voxel_material the rows hit_surface_cuda's tables held.

    frame None: linear RGB in the rays' batch shape + (3,), ray order.
    frame (height, width, tiled): render_image's gamma-corrected (H, W, 4)
    framebuffer, each ray written to its pixel (tile order when tiled)."""
    on_cuda("shade_post_cuda", surf.rec.device)
    a, out = shade_args(surf, dirs, occluded, materials, voxel_material,
                        clear_color, frame)
    launch("shade_post", a, surf.rec.device)
    trace.count("rays.shade_post", a.n)
    return out
