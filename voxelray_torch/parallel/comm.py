"""The multi-device layer: a device mesh, its collectives, and the sharded
voxelize and render paths.

Counterpart of voxelray_tpu/parallel/comm.py.  JAX's layer is single
controller: one call takes a Mesh, shard_map runs the shards and one
result comes back.  The port keeps that contract with a mesh that is a
list of torch devices (`Mesh`, `make_mesh`).  One Python loop launches
each shard's work on its device, and a collective is a plain function
over the per-device tensors that reduces them on `mesh.devices[0]` and
returns the result there (JAX's replicated outputs, as its caller sees
them).  A device may repeat: `make_mesh(devices=["cpu"] * 8)` or
`["cuda:0"] * 4` is a rehearsal mesh, whose shards run one after another
on one device (the counterpart of xla_force_host_platform_device_count);
it shows that the sharding is exact, not what it gains.

  voxelize  triangles sharded over the devices (`voxelize_sharded`), one
            K1 launch per shard, the occupancy OR-reduced and set_calls
            summed; the frames of a deforming mesh dealt over the devices
            (`voxelize_frames_sharded`), one K1 launch per frame.
  render    pixel rows sharded (`render_sharded`): each device traces its
            rows against its copy of the scene (`replicate_scene`) and
            the frame is gathered on the first device.  The grid sharded
            over Z-slabs (`render_zslab_sharded`): each device holds one
            slab's accel (or occupancy, backend "dda"), every ray is
            traced against every slab, and the hits merge by min t (ties
            to the smaller cell id), occlusion by an OR; shading runs
            once, on the first device.

No launch waits on the host between shards, so distinct cards overlap,
except where a shard's own work syncs: the staged walk of the Z-slab
trace compacts its active rays once per lap, which serialises the slabs'
laps across cards.  JAX's `window` and `chunk` arguments size a TPU tile
plan; K1 sizes each triangle's window itself, so they are not taken.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..models.scene import Light
from ..ops.intersect import TMAX, TMIN, make_camera_rays
from ..ops.kernels import voxel_accum
from ..ops.traverse import any_hit_triangles_brute, trace_grid_dda_zslab
from ..ops.traverse_fast import (any_hit_grid_fast, build_accel_slab,
                                 trace_grid_fast)
from ..ops.tri_accel import any_hit_triangles_grid
from ..render import shading
from ..render.pipeline import (_can_tile, _frame_rays, _tile_rays,
                               _untile_rays, render_rays)

__all__ = ["Mesh", "make_mesh", "shard_triangles", "or_reduce_occupancy",
           "pmin_nearest", "replicate_scene", "voxelize_sharded",
           "voxelize_frames_sharded", "render_sharded", "ZSlabs",
           "split_zslabs", "zslab_rows", "render_zslab_sharded"]

_IMAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: its devices in shard order and the axis name."""

    devices: tuple
    axis: str = "rays"

    @property
    def size(self):
        return len(self.devices)


def make_mesh(n_devices=None, axis="rays", *, devices=None) -> Mesh:
    """1-D mesh over the first n_devices CUDA devices (all by default),
    raising where there is no card or fewer than asked; or, with
    `devices`, exactly that list (repeats allowed: a rehearsal mesh)."""
    if devices is not None:
        devs = tuple(torch.device(x) for x in devices)
        if not devs or (n_devices is not None and n_devices != len(devs)):
            raise ValueError(f"make_mesh: {len(devs)} devices listed, "
                             f"n_devices={n_devices}")
        return Mesh(devs, axis)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("make_mesh: no CUDA device; a rehearsal mesh on "
                           "the CPU is make_mesh(devices=['cpu'] * n)")
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise RuntimeError(f"make_mesh: {n} devices asked, {count} CUDA "
                           "devices present")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


def _gather(parts, mesh):
    dev0 = mesh.devices[0]
    return [p.to(dev0) for p in parts]


def or_reduce_occupancy(parts, mesh: Mesh):
    """Bitwise OR of {0,1} uint8 occupancy, one tensor per device of the
    mesh: OR == max, on mesh.devices[0]."""
    return functools.reduce(torch.maximum, _gather(parts, mesh))


def pmin_nearest(parts, mesh: Mesh):
    """Merge per-device (t, lin) nearest hits: min t, then the smallest
    lin among the parts whose t equals it; (+inf, -1) on a miss
    (voxelray_tpu/parallel/comm.py:342-347)."""
    ts = _gather([t for t, _ in parts], mesh)
    lins = _gather([lin for _, lin in parts], mesh)
    t_m = functools.reduce(torch.minimum, ts)
    lin_m = functools.reduce(torch.minimum, [
        torch.where(torch.isfinite(t) & (t == t_m), lin, _IMAX)
        for t, lin in zip(ts, lins)])
    return t_m, torch.where(torch.isfinite(t_m), lin_m, -1)


def shard_triangles(tri_verts: np.ndarray, n_shards: int) -> np.ndarray:
    """Pad (F, 3, 3) triangles to a multiple of n_shards with +inf
    sentinel triangles, which K1 gives empty windows."""
    f = tri_verts.shape[0]
    per = -(-f // n_shards)
    return np.pad(tri_verts, ((0, per * n_shards - f), (0, 0), (0, 0)),
                  constant_values=np.inf)


def replicate_scene(scene, device):
    """The scene with every tensor on `device`, its accels and octree
    included; a tensor already there is not copied."""
    dev = torch.device(device)

    def move(x):
        if torch.is_tensor(x):
            return x.to(dev)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: move(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        return x

    return move(scene)


def _accum(v, f, origin, voxel_size, dims):
    """Voxelize on v's device without a host sync: (occ (Z, Y, X) uint8,
    counts (2,) int64 = set_calls and out-of-range faces).  K1 on CUDA
    tensors, the plain voxelizer on the CPU."""
    if not v.is_cuda:
        occ, calls = voxel_accum.voxel_accum(v, f, origin, voxel_size, dims)
        return occ, torch.tensor([calls, 0], device=v.device)
    return voxel_accum.accumulate(v, f, origin, voxel_size, dims)


def voxelize_sharded(tri_verts, origin, mesh: Mesh, *, dims, voxel_size):
    """Triangle-sharded voxelization with an OR merge.

    tri_verts: (F, 3, 3) float32, padded with sentinels to a multiple of
    the mesh's size and dealt in contiguous blocks, one K1 launch per
    device.  Returns (occ (Z, Y, X) uint8, set_calls 0-d int64, the
    total over shards), both on mesh.devices[0].
    """
    n = mesh.size
    tri = shard_triangles(np.asarray(tri_verts, np.float32), n)
    per = tri.shape[0] // n
    occs, counts = [], []
    for i, dev in enumerate(mesh.devices):
        v = torch.as_tensor(tri[i * per:(i + 1) * per].reshape(-1, 3),
                            device=dev)
        f = torch.arange(3 * per, dtype=torch.int32,
                         device=dev).reshape(-1, 3)
        occ, cnt = _accum(v, f, origin, voxel_size, dims)
        occs.append(occ)
        counts.append(cnt[0])
    return (or_reduce_occupancy(occs, mesh),
            functools.reduce(torch.add, _gather(counts, mesh)))


def voxelize_frames_sharded(frame_verts, faces, origin, mesh: Mesh, *, dims,
                            voxel_size):
    """Batch-of-frames data parallelism (BASELINE config 5).

    frame_verts: (F, V, 3) float32, one deformed vertex set per animation
    frame, fixed topology `faces` (T, 3).  Each device voxelizes
    ceil(F / n) whole frames, one K1 launch each, with no collective; F
    rounds up to a multiple of n by repeating the last frame, and the
    padded frames are trimmed.  Returns (occ (F, Z, Y, X) uint8,
    set_calls (F,) int64), gathered on mesh.devices[0].
    """
    n = mesh.size
    fv = np.asarray(frame_verts, np.float32)
    n_frames = fv.shape[0]
    per = -(-n_frames // n)
    if per * n > n_frames:
        fv = np.concatenate([fv, np.repeat(fv[-1:], per * n - n_frames,
                                           axis=0)])
    faces = np.asarray(faces).reshape(-1, 3).astype(np.int32)
    occs, counts = [], []
    for i, dev in enumerate(mesh.devices):
        f = torch.as_tensor(faces, device=dev)
        for j in range(i * per, (i + 1) * per):
            v = torch.as_tensor(np.ascontiguousarray(fv[j]), device=dev)
            occ, cnt = _accum(v, f, origin, voxel_size, dims)
            occs.append(occ)
            counts.append(cnt)
    occ = torch.stack(_gather(occs, mesh))[:n_frames]
    counts = torch.stack(_gather(counts, mesh))[:n_frames]
    if int(counts[:, 1].sum()):
        raise ValueError("faces index a vertex out of range")
    return occ, counts[:, 0]


def render_sharded(scene, view_inv, proj_inv, mesh: Mesh, *, width, height,
                   light=None, clear_color=(1.0, 1.0, 1.0, 1.0),
                   backend="fast", shadows=True, fast_opts=None,
                   shadow_opts=None):
    """Row-sharded render: each device traces ceil(height / n) rows
    against its copy of the scene, through render_rays with
    render_image's options; a shard's rays travel in tile order when its
    row block tiles.  Any (height, n) works: the last row repeats up to
    n blocks and the repeats are trimmed.  Returns the gamma-corrected
    (H, W, 4) frame on mesh.devices[0].
    """
    light = light or Light()
    n = mesh.size
    dev0 = mesh.devices[0]
    rows_per = -(-height // n)
    pad = rows_per * n - height
    origins, dirs = make_camera_rays(width, height, view_inv, proj_inv,
                                     device=dev0)
    if pad:
        origins = torch.cat([origins, origins[-1:].expand(pad, -1, -1)])
        dirs = torch.cat([dirs, dirs[-1:].expand(pad, -1, -1)])
    tiled = backend == "fast" and _can_tile(rows_per, width)
    parts = []
    for i, dev in enumerate(mesh.devices):
        rows = slice(i * rows_per, (i + 1) * rows_per)
        o, d = origins[rows].to(dev), dirs[rows].to(dev)
        if tiled:
            o, d = _tile_rays(o, rows_per, width), _tile_rays(d, rows_per,
                                                              width)
        rgb = render_rays(replicate_scene(scene, dev), o, d, light,
                          clear_color, backend=backend, shadows=shadows,
                          fast_opts=fast_opts, shadow_opts=shadow_opts)
        parts.append(_untile_rays(rgb, rows_per, width) if tiled else rgb)
    rgb = torch.cat(_gather(parts, mesh))[:height]
    rgba = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
    return shading.gamma_post(rgba)


def zslab_rows(occ3, a, b):
    """Rows [a, b) of a (Z, Y, X) occupancy, empty outside the grid (a
    view where they all lie in it)."""
    nz = occ3.shape[0]
    if 0 <= a and b <= nz:
        return occ3[a:b]
    out = torch.zeros((b - a,) + tuple(occ3.shape[1:]), dtype=torch.uint8,
                      device=occ3.device)
    lo, hi = max(a, 0), min(b, nz)
    if hi > lo:
        out[lo - a:hi - a] = occ3[lo:hi]
    return out


@dataclasses.dataclass(frozen=True)
class ZSlabs:
    """A voxel grid split over a mesh's devices in Z-slabs: device i holds
    rows [i * nzs, (i + 1) * nzs), slabs[i], as a build_accel_slab accel
    (backend "fast") or as the rows' occupancy, x fastest (backend
    "dda")."""

    mesh: Mesh
    backend: str
    nzs: int
    dims: tuple
    origin: np.ndarray
    voxel_size: float
    slabs: tuple

    def per_slab(self, o, d, t_min, t_max, occlusion=False):
        """Each slab's trace of the rays o, d (on any device; bounds
        scalars or per ray): (t, lin) per slab, or its occlusion."""
        parts = []
        for i, dev in enumerate(self.mesh.devices):
            args = (o.to(dev), d.to(dev), self.slabs[i])
            kw = {k: x.to(dev) if torch.is_tensor(x) else x
                  for k, x in (("t_min", t_min), ("t_max", t_max))}
            if self.backend == "dda":
                t, lin = trace_grid_dda_zslab(
                    *args[:2], self.slabs[i], self.origin, i * self.nzs,
                    dims=self.dims, nzs=self.nzs,
                    voxel_size=self.voxel_size, **kw)
                parts.append(torch.isfinite(t) if occlusion else (t, lin))
            elif occlusion:
                parts.append(any_hit_grid_fast(*args, **kw))
            else:
                parts.append(trace_grid_fast(*args, **kw))
        return parts

    def trace(self, o, d, t_min=TMIN, t_max=TMAX):
        """Nearest voxel hit (t, global cell lin), merged over the slabs
        on mesh.devices[0]."""
        return pmin_nearest(self.per_slab(o, d, t_min, t_max), self.mesh)

    def any_hit(self, o, d, t_min=TMIN, t_max=TMAX):
        """Voxel occlusion, OR-reduced over the slabs on
        mesh.devices[0]."""
        return functools.reduce(torch.logical_or, _gather(
            self.per_slab(o, d, t_min, t_max, True), self.mesh))


def split_zslabs(scene, mesh: Mesh, backend="fast") -> ZSlabs:
    """Split a voxel scene's grid over the mesh's devices in Z-slabs of
    nzs = ceil(nz / n) rows (for backend "fast" rounded up to whole
    bricks), on the host: each device receives only its rows (with, for
    "fast", the brick layer under and over them for the fine table's
    halo) and builds its slab there."""
    if backend not in ("fast", "dda"):
        raise ValueError(f"Z-slab backend {backend!r}, one of ('fast', "
                         "'dda')")
    nx, ny, nz = scene.grid_dims
    if nz == 0:
        raise ValueError("a Z-slab split needs a voxel grid scene")
    nzs = -(-nz // mesh.size)
    if backend == "fast":
        nzs = -(-nzs // 8) * 8                  # brick-aligned boundaries
    occ3 = scene.occ_flat.reshape(nz, ny, nx).cpu()
    origin = scene.grid_origin.cpu().numpy()
    vs = scene.grid_voxel_size
    slabs = []
    for i, dev in enumerate(mesh.devices):
        z0, z1 = i * nzs, (i + 1) * nzs
        if backend == "dda":
            slabs.append(zslab_rows(occ3, z0, z1).reshape(-1).to(dev))
            continue
        slabs.append(build_accel_slab(
            zslab_rows(occ3, z0, z1).to(dev), z0, nz, origin, vs,
            below=zslab_rows(occ3, z0 - 8, z0).to(dev) if z0 else None,
            above=zslab_rows(occ3, z1, z1 + 8).to(dev) if z1 < nz else None))
    return ZSlabs(mesh, backend, nzs, (nx, ny, nz), origin, vs, tuple(slabs))


def render_zslab_sharded(scene, view_inv, proj_inv, mesh: Mesh, *, width,
                         height, light=None,
                         clear_color=(1.0, 1.0, 1.0, 1.0), shadows=True,
                         backend="fast"):
    """Render with the occupancy grid sharded over Z-slabs
    (voxelray_tpu/parallel/comm.py:216-374; split_zslabs): each device
    holds one slab, as an accel with a one-brick-layer halo in its fine
    table (backend "fast", the staged walk K3 + K4 over it) or as
    occupancy (backend "dda", trace_grid_dda_zslab).  Every ray is traced
    against every slab with global coordinates; the nearest hits merge
    by min t (ties to the smaller cell id), occlusion by an OR.  The
    shading is render_rays' on mesh.devices[0], against a copy of the
    scene without its grid (a one-cell occ_flat keeps the voxel shading's
    branches); triangles stay replicated there.  Returns the gamma-
    corrected (H, W, 4) frame on mesh.devices[0].
    """
    light = light or Light()
    zs = split_zslabs(scene, mesh, backend)
    scene_rep = replicate_scene(dataclasses.replace(
        scene, occ_flat=torch.ones(1, dtype=torch.uint8), accel=None,
        octree=None, voxel_aabbs=torch.zeros((0, 6))), mesh.devices[0])

    def any_hit_fn(o, d, t_min, t_max):
        occl = zs.any_hit(o, d, t_min, t_max)
        if scene_rep.tri_accel is not None:
            occl |= any_hit_triangles_grid(o, d, scene_rep.tri_accel,
                                           t_min=t_min, t_max=t_max)
        elif scene_rep.n_triangles:
            occl |= any_hit_triangles_brute(
                o, d, scene_rep.tri_v0, scene_rep.tri_v1, scene_rep.tri_v2,
                t_min=t_min, t_max=t_max)
        return occl

    origins, dirs, untile = _frame_rays(scene_rep, view_inv, proj_inv, width,
                                        height, backend)
    rgb = untile(render_rays(scene_rep, origins, dirs, light, clear_color,
                             backend="dda", shadows=shadows,
                             trace_voxels_fn=zs.trace,
                             any_hit_fn=any_hit_fn))
    rgba = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
    return shading.gamma_post(rgba)
