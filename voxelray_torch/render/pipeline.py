"""The render pipeline: camera rays to a gamma-corrected frame.

Counterpart of voxelray_tpu/render/pipeline.py.  Per pixel (the
reference's raygen -> closest hit -> shadow ray -> miss -> post chain):

  raygen (raytrace.rgen:39-67)
    -> nearest hit over { triangles, voxels }: triangles through the
       tri-grid march when the scene has a triangle accel (the
       tri_march kernel), else the brute trace; voxels with backend
       "octree" (the octree walk) when the scene has an octree, "fast"
       (the megakernel K2, or with fast_opts {"mega": False} the staged
       walk, one staged_march launch: K3's and K4's walks in one kernel)
       when it has a brick accel, "dda" (the exhaustive
       DDA) when it has an occupancy grid, and otherwise the brute trace
       over the scene's AABB list (backend "brute")
    -> triangle CH (raytrace.rchit): interpolated normal, texture-
       modulated diffuse (base mip level), attenuation 1 -> shadow ray
       if dot(N,L) > 0 -> 0.3 if shadowed else specular
    -> voxel CH (raytrace2.rchit): dominant-axis cube normal, attenuation
       0.3 by default -> shadow ray if dot(N,L) > 0 -> 1 + specular if
       unshadowed
    -> miss: clearColor * 0.8 (raytrace.rmiss:37)
  post: pow(rgba, 1/2.2) (post.frag:35-36)

render_aov returns the same traces' depth, normal and hit mask,
unshaded.  The shadow pass traces only the rays of pixels that hit
something facing the light (the admit mask); the others' shadow results
could not change the image.  Fast-backend rays travel in 8x128 tile
order when the frame tiles, so a warp of a kernel walks neighbouring
pixels.

On CUDA tensors the per-pixel glue around the traces is three kernels
(ops/kernels/frame_shade.py): camera_rays (raygen), hit_surface (the
closest-hit terms and the shadow query) and shade_post (shading, miss,
alpha and gamma, written straight into the framebuffer).  Their plain
version is the PyTorch code of this module (make_camera_rays, _tile_rays,
surface_terms, the shade stage, gamma_post), which CPU tensors run; any
other device raises.  An octree frame on the card (backend "octree", no
triangles) is the same five launches every frame; render_image keeps
their argument blocks and the buffers between them for the scene
(_OctreeFrame) and only writes each frame's camera and framebuffer in.
"""
from __future__ import annotations

import weakref
from typing import NamedTuple

import torch

from ..ops.intersect import TMAX, TMIN, make_camera_rays
from ..ops.kernels import frame_shade, octree_walk
from ..ops.kernels._build import launch
from ..ops.octree_traverse import any_hit_octree, trace_octree
from ..ops.traverse import (any_hit_aabbs_brute, any_hit_grid_dda,
                            any_hit_triangles_brute, trace_aabbs_brute,
                            trace_grid_dda, trace_triangles_brute)
from ..ops.traverse_fast import any_hit_grid_fast, trace_grid_fast
from ..ops.tri_accel import any_hit_triangles_grid, trace_triangles_grid
from . import shading
from .camera import Camera
from ..models.scene import Light, Scene
from ..utils import trace

__all__ = ["render_rays", "render_image", "render_scene", "render_aov",
           "Surface", "surface_terms"]

_BACKENDS = ("fast", "dda", "brute", "octree")


def _check_backend(backend):
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend '{backend}'; one of {_BACKENDS}")


def _takes_kernels(dev):
    """Whether a frame on `dev` runs the frame glue's kernels (CUDA) or the
    plain PyTorch glue (CPU); other devices raise."""
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"render: unsupported device {dev}")


def _sample_texture(textures, tex_meta, layer, uv, lod=None):
    """Bilinear/trilinear sample with repeat addressing; layer -1 ->
    white.  textures is the (T, TH, TWA, 3) mip-atlas stack, tex_meta the
    (T, LMAX, 4) per-level (y0, x0, h, w) placements: every texture
    samples with its own dims.  lod=None samples the base level, which is
    what the reference's closest-hit stage reads (implicit-lod texture()
    has no derivatives there); a float lod tensor filters trilinearly
    across the mip chain (the raster path's sampler)."""
    layer_c = torch.clamp(layer, 0, textures.shape[0] - 1).long()
    lmax = tex_meta.shape[1]
    uvw = uv - torch.floor(uv)

    def level_sample(lv):
        meta = tex_meta[layer_c, lv].long()                 # (..., 4)
        y0, x0, hh, ww = meta.unbind(-1)
        u = uvw[..., 0] * ww.to(torch.float32) - 0.5
        v = uvw[..., 1] * hh.to(torch.float32) - 0.5
        xf = torch.floor(u)
        yf = torch.floor(v)
        fu = (u - xf)[..., None]
        fv = (v - yf)[..., None]
        xi = xf.long()
        yi = yf.long()

        def fetch(xa, ya):
            # xi in [-1, w-1] and xi+1 in [0, w]: only the edges wrap
            xa = torch.where(xa < 0, ww - 1, torch.where(xa >= ww, 0, xa))
            ya = torch.where(ya < 0, hh - 1, torch.where(ya >= hh, 0, ya))
            return textures[layer_c, ya + y0, xa + x0]

        return (fetch(xi, yi) * (1 - fu) * (1 - fv)
                + fetch(xi + 1, yi) * fu * (1 - fv)
                + fetch(xi, yi + 1) * (1 - fu) * fv
                + fetch(xi + 1, yi + 1) * fu * fv)

    if lod is None:
        c = level_sample(torch.zeros_like(layer_c))
    else:
        lod = torch.clamp(lod, 0.0, float(lmax - 1))
        # a NaN lod samples level 0 and, through fl, gives a NaN colour
        l0 = torch.floor(torch.nan_to_num(lod)).long()
        l1 = torch.clamp(l0 + 1, max=lmax - 1)
        fl = (lod - l0.to(torch.float32))[..., None]
        c = level_sample(l0) * (1 - fl) + level_sample(l1) * fl
    return torch.where((layer >= 0)[..., None], c, torch.ones_like(c))


def _trace_triangles(scene: Scene, origins, dirs, t_min, t_max):
    """Nearest triangle hit (t, tri_id, u, v): the tri-grid march when the
    scene carries a triangle accel, the brute trace otherwise."""
    if scene.tri_accel is not None:
        return trace_triangles_grid(origins, dirs, scene.tri_accel,
                                    t_min=t_min, t_max=t_max)
    return trace_triangles_brute(origins, dirs, scene.tri_v0, scene.tri_v1,
                                 scene.tri_v2, t_min=t_min, t_max=t_max)


def _fast_opts(scene: Scene, opts):
    """The fast backend's options with JAX's default: the megakernel when
    the accel carries its superbrick table (pipeline.py:121-126)."""
    opts = dict(opts or {})
    opts.setdefault("mega", scene.accel.fine_sb is not None)
    return opts


def _voxel_route(scene: Scene, backend):
    """The voxel traversal a backend takes on this scene, in the JAX
    package's dispatch order (pipeline.py:112-200): the octree walk, the
    brick accel, the dense DDA, else the brute trace over voxel_aabbs."""
    if backend == "octree" and scene.octree is not None:
        return "octree"
    if backend == "fast" and scene.accel is not None:
        return "fast"
    if backend == "dda" and scene.occ_flat.shape[0] > 0:
        return "dda"
    return "brute"


def _trace_voxels(scene: Scene, origins, dirs, t_min, t_max, backend,
                  fast_opts=None):
    """Nearest voxel hit (t, id): id is a cell's linear index, or on the
    brute route the index of the hit box in voxel_aabbs."""
    route = _voxel_route(scene, backend)
    if route == "octree":
        return trace_octree(origins, dirs, scene.octree, t_min=t_min,
                            t_max=t_max)
    if route == "fast":
        return trace_grid_fast(origins, dirs, scene.accel, t_min=t_min,
                               t_max=t_max, **_fast_opts(scene, fast_opts))
    if route == "dda":
        return trace_grid_dda(origins, dirs, scene.occ_flat,
                              scene.grid_origin, dims=scene.grid_dims,
                              voxel_size=scene.grid_voxel_size, t_min=t_min,
                              t_max=t_max)
    return trace_aabbs_brute(origins, dirs, scene.voxel_aabbs, t_min=t_min,
                             t_max=t_max)


def _count_shadow(occluded, admit):
    """While recording: the shadow rays handed to a trace that reads the
    admit mask itself (all of them) and those admitted."""
    if trace.enabled():
        n = occluded.numel()
        trace.count("shadow.rays", n)
        if admit is None:
            trace.count("shadow.admitted", n)
        else:
            trace.count_device("shadow.admitted", admit)


def _any_hit(scene: Scene, origins, dirs, t_min, t_max, backend, admit,
             fast_opts=None, shadow_opts=None):
    """Occlusion of the shadow rays.  With an admit mask only the admitted
    rays are traced (K2 and the octree walk take the mask, the other
    traces the admitted rays compacted); the others come back
    unoccluded."""
    route = _voxel_route(scene, backend)
    if route == "octree":
        # the whole batch and the mask to the walk, which on the card reads
        # the mask itself (no compaction, no sync)
        occluded = any_hit_octree(origins, dirs, scene.octree, t_min=t_min,
                                  t_max=t_max, admit=admit)
        _count_shadow(occluded, admit)
        route = None
    else:
        occluded = torch.zeros(origins.shape[:-1], dtype=torch.bool,
                               device=origins.device)
    if route == "fast":
        # shadow coverage has its own defaults: of fast_opts only the
        # layout knob two_level carries over (pipeline.py:170-190)
        opts = {k: v for k, v in (fast_opts or {}).items()
                if k == "two_level"}
        opts.update(_fast_opts(scene, shadow_opts))
        occluded = any_hit_grid_fast(origins, dirs, scene.accel,
                                     t_min=t_min, t_max=t_max, admit=admit,
                                     **opts)
        _count_shadow(occluded, admit)
    if route == "brute" and not scene.n_voxels:
        route = None
    if not scene.n_triangles and route in ("fast", None):
        return occluded
    o, d = origins.reshape(-1, 3), dirs.reshape(-1, 3)
    tmx = t_max.reshape(-1)
    if admit is not None:
        sel = torch.nonzero(admit.reshape(-1)).squeeze(1)
        o, d, tmx = o[sel], d[sel], tmx[sel]
    hit = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    if scene.n_triangles:
        if scene.tri_accel is not None:
            hit |= any_hit_triangles_grid(o, d, scene.tri_accel,
                                          t_min=t_min, t_max=tmx)
        else:
            hit |= any_hit_triangles_brute(o, d, scene.tri_v0, scene.tri_v1,
                                           scene.tri_v2, t_min=t_min,
                                           t_max=tmx)
    if route == "dda":
        hit |= any_hit_grid_dda(o, d, scene.occ_flat, scene.grid_origin,
                                dims=scene.grid_dims,
                                voxel_size=scene.grid_voxel_size,
                                t_min=t_min, t_max=tmx)
    elif route == "brute":
        hit |= any_hit_aabbs_brute(o, d, scene.voxel_aabbs, t_min=t_min,
                                   t_max=tmx)
    if trace.enabled():
        calls = bool(scene.n_triangles) + (route in ("dda", "brute"))
        trace.count("shadow.rays", calls * o.shape[0])
        trace.count("shadow.admitted", calls * o.shape[0])
    if admit is not None:
        occluded.reshape(-1)[sel] |= hit
        return occluded
    return occluded | hit.reshape(occluded.shape)


def _voxel_centres(scene: Scene, backend):
    """What a voxel hit's id indexes on the voxel route `backend` takes:
    (boxes, None) on the brute route, whose ids are boxes of voxel_aabbs,
    else (None, (origin, dims, voxel_size)) of the grid whose cells they
    are (the octree's or the scene's)."""
    route = _voxel_route(scene, backend)
    if route == "brute":
        return scene.voxel_aabbs, None
    if route == "octree":
        tree = scene.octree
        return None, (tree.origin, tree.dims, tree.voxel_size)
    return None, (scene.grid_origin, scene.grid_dims,
                  scene.grid_voxel_size)


def _voxel_center_of_hit(scene: Scene, hit_id, backend):
    """Centre of the hit voxel, the (min+max)/2 the voxel CH computes
    (raytrace2.rchit:57-60): of the cell `hit_id` on the grid routes, of
    the box `hit_id` of voxel_aabbs on the brute route."""
    boxes, grid = _voxel_centres(scene, backend)
    if boxes is not None:
        box = boxes[torch.clamp(hit_id, min=0).long()]
        return (box[..., 0:3] + box[..., 3:6]) * 0.5
    org, dims, vs = grid
    org = torch.as_tensor(org, device=hit_id.device)
    nx, ny, _ = dims
    lin = torch.clamp(hit_id, min=0).long()
    idx = torch.stack([lin % nx, (lin // nx) % ny, lin // (nx * ny)],
                      dim=-1).to(torch.float32)
    return org + (idx + 0.5) * vs


class Surface(NamedTuple):
    """Per-ray terms at the nearest hit of a traced ray batch."""

    hit: torch.Tensor          # bool: the ray hit a triangle or a voxel
    vox_hit: torch.Tensor      # bool: the nearest hit is a voxel
    world_pos: torch.Tensor    # hit point (origin + dir * 1 on a miss)
    normal: torch.Tensor       # shading normal
    mat: torch.Tensor          # (..., 20) material row
    diffuse: torch.Tensor      # diffuse term, texture-modulated
    l_vec: torch.Tensor        # unit vector toward the light
    intensity: torch.Tensor    # light intensity at the hit point
    light_dist: torch.Tensor   # shadow-ray t_max
    facing: torch.Tensor       # bool: dot(normal, l_vec) > 0


def surface_terms(scene: Scene, origins, dirs, t_vox, vox_id,
                  light: Light = Light(), tri=None,
                  backend="dda") -> Surface:
    """Closest-hit terms of a traced batch (pipeline.py:217-276).

    tri: the triangle trace (t, tri_id, u, v), or None for no triangle
    hits.  backend: the one the voxel trace took, which says whether
    vox_id is a cell or a box of voxel_aabbs.  The frame's shadow query
    is (world_pos, l_vec, TMIN, light_dist) for the rays with hit &
    facing.
    """
    shape = origins.shape[:-1]
    dev = origins.device
    if tri is None:
        z = torch.zeros(shape, device=dev)
        tri = (torch.full(shape, float("inf"), device=dev),
               torch.full(shape, -1, dtype=torch.int32, device=dev), z, z)
    t_tri, tri_id, bu, bv = tri
    vox_hit = torch.isfinite(t_vox) & (t_vox < t_tri)
    tri_hit = torch.isfinite(t_tri) & ~vox_hit
    hit = vox_hit | tri_hit
    t_hit = torch.where(vox_hit, t_vox, t_tri)
    t_safe = torch.where(hit, t_hit, torch.ones_like(t_hit))
    world_pos = origins + dirs * t_safe[..., None]

    has_tri = scene.n_triangles > 0
    tid = torch.clamp(tri_id, min=0).long()
    w = (1.0 - bu - bv)[..., None]
    if has_tri:
        n_tri = (scene.tri_n0[tid] * w + scene.tri_n1[tid] * bu[..., None]
                 + scene.tri_n2[tid] * bv[..., None])
        n_tri = n_tri / torch.clamp(torch.sqrt(shading.dot3(n_tri, n_tri)),
                                    min=1e-20)
    else:
        n_tri = torch.zeros_like(world_pos)
    if scene.n_voxels or scene.occ_flat.shape[0]:
        n_vox = shading.cube_normal(
            world_pos, _voxel_center_of_hit(scene, vox_id, backend))
    else:
        n_vox = torch.zeros_like(world_pos)
    normal = torch.where(vox_hit[..., None], n_vox, n_tri)

    vox_mat = scene.voxel_material.expand(shape + (20,))
    mat_tri = scene.materials[scene.tri_mat[tid].long()] if has_tri \
        else vox_mat
    mat = torch.where(vox_hit[..., None], vox_mat, mat_tri)

    l_vec, intensity, light_dist = shading.light_terms(
        world_pos, light.position, light.intensity, light.type)
    diffuse = shading.compute_diffuse(mat, l_vec, normal)
    if has_tri:
        uv = (scene.tri_uv0[tid] * w + scene.tri_uv1[tid] * bu[..., None]
              + scene.tri_uv2[tid] * bv[..., None])
        tex_rgb = _sample_texture(scene.textures, scene.tex_meta,
                                  scene.tri_tex[tid], uv)
        diffuse = torch.where(tri_hit[..., None], diffuse * tex_rgb, diffuse)
    facing = shading.dot3(normal, l_vec)[..., 0] > 0.0
    return Surface(hit, vox_hit, world_pos, normal, mat, diffuse, l_vec,
                   intensity, light_dist, facing)


def _surface_tables(scene: Scene, backend):
    """What the hit_surface kernel reads of the scene besides the traces:
    its material and triangle rows, and the boxes or grid whose centres
    give a voxel hit its normal (_voxel_centres)."""
    tri = {}
    if scene.n_triangles:
        tri = dict(tri_n=(scene.tri_n0, scene.tri_n1, scene.tri_n2),
                   tri_uv=(scene.tri_uv0, scene.tri_uv1, scene.tri_uv2),
                   tri_mat=scene.tri_mat, tri_tex=scene.tri_tex,
                   textures=scene.textures, tex_meta=scene.tex_meta)
    boxes = grid = None
    if scene.n_voxels or scene.occ_flat.shape[0]:
        boxes, grid = _voxel_centres(scene, backend)
    return frame_shade.Tables(scene.materials, scene.voxel_material,
                              boxes=boxes, grid=grid, **tri)


def _occlusion(scene: Scene, world_pos, l_vec, light_dist, admit, backend,
               fast_opts, shadow_opts, any_hit_fn):
    """The shadow pass: bool occlusion of the admitted shadow rays
    (world_pos, l_vec, TMIN, light_dist), False for the others."""
    if any_hit_fn is None:
        return _any_hit(scene, world_pos, l_vec, TMIN, light_dist, backend,
                        admit, fast_opts, shadow_opts)
    shadowed = torch.zeros_like(admit)
    sel = torch.nonzero(admit.reshape(-1)).squeeze(1)
    shadowed.reshape(-1)[sel] = any_hit_fn(
        world_pos.reshape(-1, 3)[sel], l_vec.reshape(-1, 3)[sel], TMIN,
        light_dist.reshape(-1)[sel]).reshape(-1)
    return shadowed


def render_rays(scene: Scene, origins, dirs, light: Light = Light(),
                clear_color=(1.0, 1.0, 1.0, 1.0), *, backend="dda",
                t_min=TMIN, t_max=TMAX, shadows=True, fast_opts=None,
                shadow_opts=None, trace_voxels_fn=None, any_hit_fn=None):
    """Trace + shade a ray batch; returns linear-space RGB (..., 3).

    fast_opts: options of trace_grid_fast for backend "fast" ("mega",
    "k_hits", "two_level"); {"mega": False} selects the staged walk
    (staged_march).  shadow_opts: the same for the shadow pass
    (any_hit_grid_fast).  Both default to the megakernel when the accel
    carries its superbrick table.

    trace_voxels_fn / any_hit_fn replace the voxel nearest-hit query and
    the whole occlusion query (voxelray_tpu/render/pipeline.py:202-226,
    :290): the Z-slab render (parallel/comm.py render_zslab_sharded) puts
    its per-slab traces and their merge there, so the shading is this
    code.
    trace_voxels_fn(origins, dirs, t_min, t_max) -> (t, cell lin);
    any_hit_fn(origins, dirs, t_min, t_max) -> bool occluded, called on
    the admitted shadow rays (hit & facing) compacted to (M, 3), with
    t_max (M,).
    """
    _check_backend(backend)
    return _render(scene, origins, dirs, light, clear_color, None,
                   backend=backend, t_min=t_min, t_max=t_max,
                   shadows=shadows, fast_opts=fast_opts,
                   shadow_opts=shadow_opts, trace_voxels_fn=trace_voxels_fn,
                   any_hit_fn=any_hit_fn)


def _render(scene: Scene, origins, dirs, light, clear_color, frame, *,
            backend, t_min, t_max, shadows, fast_opts, shadow_opts,
            trace_voxels_fn, any_hit_fn):
    """render_rays' stages.  On CUDA tensors the surface and shade stages
    are the hit_surface and shade_post kernels; with frame (height, width,
    tiled) shade_post returns render_image's gamma-corrected (H, W, 4)
    framebuffer, else linear RGB.  CPU tensors run the plain glue and
    return linear RGB."""
    kernels = _takes_kernels(origins.device)
    with trace.span("primary"):
        tri = (_trace_triangles(scene, origins, dirs, t_min, t_max)
               if scene.n_triangles else None)
        if trace_voxels_fn is not None:
            t_vox, vox_id = trace_voxels_fn(origins, dirs, t_min, t_max)
        else:
            t_vox, vox_id = _trace_voxels(scene, origins, dirs, t_min,
                                          t_max, backend, fast_opts)
    if kernels:
        with trace.span("surface"):
            q = frame_shade.hit_surface_cuda(
                origins, dirs, t_vox, vox_id, tri,
                _surface_tables(scene, backend), light.position,
                light.intensity, light.type)
        with trace.span("shadow"):
            occluded = (_occlusion(scene, q.world_pos, q.l_vec, q.light_dist,
                                   q.admit, backend, fast_opts, shadow_opts,
                                   any_hit_fn) if shadows else None)
        with trace.span("shade"):
            return frame_shade.shade_post_cuda(
                q, dirs, occluded, scene.materials, scene.voxel_material,
                clear_color, frame)
    with trace.span("surface"):
        s = surface_terms(scene, origins, dirs, t_vox, vox_id, light, tri,
                          backend)
    with trace.span("shadow"):
        if shadows:
            shadowed = _occlusion(scene, s.world_pos, s.l_vec, s.light_dist,
                                  s.hit & s.facing, backend, fast_opts,
                                  shadow_opts, any_hit_fn)
            shadowed = torch.where(s.facing, shadowed,
                                   torch.ones_like(shadowed))
        else:
            # shadows disabled: every facing surface counts as lit
            shadowed = ~s.facing

    with trace.span("shade"):
        return _shade(s, dirs, shadowed, clear_color)


def _shade(s: Surface, dirs, shadowed, clear_color):
    """The shade stage's plain version: linear RGB of the traced batch
    from its closest-hit terms and shadowed (True where not lit)."""
    specular = shading.compute_specular(s.mat, dirs, s.l_vec, s.normal)
    lit = s.facing & ~shadowed
    # triangle CH: attenuation 1 unless facing and shadowed -> 0.3;
    # voxel CH: attenuation 0.3 unless facing and unshadowed -> 1
    att_tri = torch.where(s.facing & shadowed, 0.3, 1.0)
    att_vox = torch.where(lit, 1.0, 0.3)
    attenuation = torch.where(s.vox_hit, att_vox, att_tri)
    specular = torch.where(lit[..., None], specular,
                           torch.zeros_like(specular))
    color = s.intensity[..., None] * attenuation[..., None] \
        * (s.diffuse + specular)
    miss = shading.miss_color(clear_color, device=color.device)
    return torch.where(s.hit[..., None], color, miss)


_TILE_H, _TILE_W = 8, 128


def _can_tile(height, width):
    return height % _TILE_H == 0 and width % _TILE_W == 0


def _tile_rays(x, height, width):
    """(H, W, C) -> (N, C) in tile order: consecutive rays cover an
    (8, 128)-pixel tile row by row, and tiles stack column-major."""
    c = x.shape[-1]
    t = x.reshape(height // _TILE_H, _TILE_H, width // _TILE_W, _TILE_W, c)
    return t.permute(2, 0, 1, 3, 4).reshape(-1, c)


def _untile_rays(x, height, width):
    c = x.shape[-1]
    t = x.reshape(width // _TILE_W, height // _TILE_H, _TILE_H, _TILE_W, c)
    return t.permute(1, 2, 0, 3, 4).reshape(height, width, c)


def _tiles(backend, height, width):
    """Whether the frame's rays travel in tile order."""
    return backend == "fast" and _can_tile(height, width)


def _frame_rays(scene: Scene, view_inv, proj_inv, width, height, backend):
    """The frame's camera rays on the scene's device, in tile order for
    the fast backend when the frame tiles: (origins, dirs, untile), where
    untile maps a per-ray (..., C) result back to (H, W, C).  On the card
    one camera_rays launch makes them, already tiled."""
    tiled = _tiles(backend, height, width)
    if _takes_kernels(scene.device):
        origins, dirs = frame_shade.camera_rays_cuda(
            width, height, view_inv, proj_inv, tiled, scene.device)
        if not tiled:
            return (origins.reshape(height, width, 3),
                    dirs.reshape(height, width, 3), lambda x: x)
    else:
        origins, dirs = make_camera_rays(width, height, view_inv, proj_inv,
                                         device=scene.device)
        if not tiled:
            return origins, dirs, lambda x: x
        origins = _tile_rays(origins, height, width)
        dirs = _tile_rays(dirs, height, width)
    return origins, dirs, lambda x: _untile_rays(x, height, width)


class _OctreeFrame:
    """An octree frame's launches on the card, kept for its scene.

    With backend "octree", no triangles and a nonempty tree, a frame is
    camera_rays, octree_walk, hit_surface, octree_walk over the shadow
    rays (when shadows are on) and shade_post, each reading what the one
    before wrote, and nothing in them changes from frame to frame but the
    camera.  Their blocks are built once, by the wrappers' own builders,
    with the buffers between the kernels (the rays, the hits, the surface
    record, the occlusion); a frame writes its camera into a copy of the
    rays block and a new framebuffer into a copy of the shade block, and
    launches the five on the stream the blocks were built for, with the
    spans and counters the wrappers' calls make.  The kernels of one
    stream run in order, so a frame's kernels overwrite those buffers only
    after the frame before has read them."""

    def __init__(self, scene: Scene, width, height, light, clear_color,
                 shadows, device):
        tree, n = scene.octree, width * height
        self.device, self.n, self.size = device, n, (height, width)
        self.rays, o, d = frame_shade.rays_args(
            width, height, torch.eye(4), torch.eye(4), False, device)
        self.walk, (t, lin), _ = octree_walk.walk_args(o, d, TMIN, TMAX,
                                                       tree)
        self.surface, q = frame_shade.surface_args(
            o, d, t, lin, None, _surface_tables(scene, "octree"),
            light.position, light.intensity, light.type)
        self.shadow = occluded = None
        if shadows:
            self.shadow, (occluded,), _ = octree_walk.walk_args(
                q.world_pos, q.l_vec, TMIN, q.light_dist, tree,
                admit=q.admit, any_hit=True)
        self.shade, _ = frame_shade.shade_args(
            q, d, occluded, scene.materials, scene.voxel_material,
            clear_color, (height, width, False))
        self.admit, self.occluded = q.admit, occluded
        self.held = (o, d, t, lin, q)

    def frame(self, view_inv, proj_inv):
        """The frame from the camera (view_inv, proj_inv), as render_image
        returns it."""
        dev, n = self.device, self.n
        with trace.span("render_image"):
            with trace.span("rays"):
                a = frame_shade.RaysArgs.from_buffer_copy(self.rays)
                frame_shade.rays_camera(a, view_inv, proj_inv)
                launch("camera_rays", a, dev)
                trace.count("rays.camera_rays", n)
            with trace.span("primary"), trace.span("octree_walk"):
                octree_walk.relaunch(self.walk, dev)
            with trace.span("surface"):
                launch("hit_surface", self.surface, dev)
                trace.count("rays.hit_surface", n)
            with trace.span("shadow"):
                if self.shadow is not None:
                    with trace.span("octree_walk"):
                        octree_walk.relaunch(self.shadow, dev)
                    _count_shadow(self.occluded, self.admit)
            with trace.span("shade"):
                out = torch.empty(self.size + (4,), dtype=torch.float32,
                                  device=dev)
                a = frame_shade.ShadeArgs.from_buffer_copy(self.shade)
                a.out = out.data_ptr()
                launch("shade_post", a, dev)
                trace.count("rays.shade_post", n)
            with trace.span("post"):
                return out


# id of a scene -> (weak reference to it, the key of its kept octree
# frame, the frame): one for each scene, made anew when the key changes
_OCTREE_FRAMES = {}


def _octree_frame(scene: Scene, width, height, light, clear_color,
                  shadows):
    """The scene's _OctreeFrame for these arguments on the current stream
    of its device, or None where its frame is not the octree's five
    launches."""
    tree = scene.octree
    if (scene.n_triangles or tree is None or tree.n_items == 0
            or tree.bits_per_axis == 0):
        return None
    dev = scene.device
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (int(width), int(height), tuple(map(float, light.position)),
           float(light.intensity), int(light.type),
           tuple(map(float, clear_color)), bool(shadows), dev,
           torch._C._cuda_getCurrentRawStream(dev.index))
    held = _OCTREE_FRAMES.get(id(scene))
    if held is not None and held[0]() is scene and held[1] == key:
        return held[2]
    plan = _OctreeFrame(scene, key[0], key[1], light, clear_color, shadows,
                        dev)
    _OCTREE_FRAMES[id(scene)] = (weakref.ref(
        scene, lambda _, k=id(scene): _OCTREE_FRAMES.pop(k, None)), key,
        plan)
    return plan


def render_image(scene: Scene, view_inv, proj_inv, *, width, height,
                 light: Light = Light(), clear_color=(1.0, 1.0, 1.0, 1.0),
                 backend="dda", shadows=True, fast_opts=None,
                 shadow_opts=None):
    """Framebuffer (H, W, 4) float32 on the scene's device,
    gamma-corrected.  fast_opts / shadow_opts as in render_rays.

    With tracing on (utils/trace.py) the call is one span
    "render_image" whose children are the frame's stages: "rays",
    "primary", "surface", "shadow", "shade" and "post"; a trace kernel's
    call ("mega_trace", "staged_march", "tri_march", "octree_walk") is a
    span under
    "primary" or "shadow".  On the card the frame is the camera_rays,
    hit_surface and shade_post kernels around the traces, and "post" only
    returns the framebuffer shade_post wrote."""
    _check_backend(backend)
    kernels = _takes_kernels(scene.device)
    if kernels and _voxel_route(scene, backend) == "octree":
        plan = _octree_frame(scene, width, height, light, clear_color,
                             shadows)
        if plan is not None:
            return plan.frame(view_inv, proj_inv)
    with trace.span("render_image"):
        with trace.span("rays"):
            origins, dirs, untile = _frame_rays(scene, view_inv, proj_inv,
                                                width, height, backend)
        out = _render(scene, origins, dirs, light, clear_color,
                      (height, width, _tiles(backend, height, width))
                      if kernels else None,
                      backend=backend, t_min=TMIN, t_max=TMAX,
                      shadows=shadows, fast_opts=fast_opts,
                      shadow_opts=shadow_opts, trace_voxels_fn=None,
                      any_hit_fn=None)
        with trace.span("post"):
            if kernels:
                return out      # shade_post wrote the framebuffer
            rgb = untile(out)
            rgba = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
            return shading.gamma_post(rgba)


def render_scene(scene: Scene, camera: Camera = Camera(), *, width=1280,
                 height=720, light: Light = Light(),
                 clear_color=(1.0, 1.0, 1.0, 1.0), backend="dda",
                 shadows=True):
    """Convenience wrapper: camera dataclass in, image out (the main.cpp
    frame loop without the window)."""
    _, _, view_inv, proj_inv = camera.matrices(width, height)
    return render_image(scene, view_inv, proj_inv, width=width,
                        height=height, light=light, clear_color=clear_color,
                        backend=backend, shadows=shadows)


def render_aov(scene: Scene, camera: Camera = Camera(), *, width=1280,
               height=720, backend="dda"):
    """Depth + normal + hit-mask buffers (the BASELINE config-3 output:
    hit distance and surface normal per pixel, no shading), as
    voxelray_tpu/render/pipeline.py:440-482 computes them.

    Returns depth (H, W) float32 (+inf on a miss), normal (H, W, 3) (the
    shading normal, zero on a miss; a voxel's normal is taken from the
    cell or box the backend hit) and hit (H, W) bool, on the scene's
    device.
    """
    _check_backend(backend)
    _, _, view_inv, proj_inv = camera.matrices(width, height)
    origins, dirs, untile = _frame_rays(scene, view_inv, proj_inv, width,
                                        height, backend)
    tri = (_trace_triangles(scene, origins, dirs, TMIN, TMAX)
           if scene.n_triangles else None)
    t_vox, vox_id = _trace_voxels(scene, origins, dirs, TMIN, TMAX, backend)
    s = surface_terms(scene, origins, dirs, t_vox, vox_id, tri=tri,
                      backend=backend)
    t_hit = t_vox if tri is None else torch.where(s.vox_hit, t_vox, tri[0])
    depth = torch.where(s.hit, t_hit, torch.full_like(t_hit, float("inf")))
    normal = torch.where(s.hit[..., None], s.normal,
                         torch.zeros_like(s.normal))
    return (untile(depth[..., None])[..., 0], untile(normal),
            untile(s.hit[..., None])[..., 0])
