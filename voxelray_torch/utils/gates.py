"""Runners for the five BASELINE.json gate configurations.

Counterpart of voxelray_tpu/utils/gates.py.  Each runner executes its
config end to end and returns a result dict with the artifacts a judge
can check (occupancy counts, image stats).  Scale parameters live in
utils.config.BASELINE_CONFIGS; tests run shrunken variants on the CPU
(device="cpu"), the full ones run on the card.  Gate 5 deals its frame
batch over a device mesh (parallel/comm.py) and reports its size.
"""
from __future__ import annotations

import numpy as np
import torch

from ..io import meshes
from ..models.grids import GridBool, build_grid
from ..models.scene import build_scene
from ..ops.geometry import grid_dims, mesh_bbox
from ..oracle import oracle_voxelize
from ..parallel.comm import make_mesh, voxelize_frames_sharded
from ..render.camera import Camera, orbit_path
from ..render.pipeline import render_aov, render_scene
from .config import BASELINE_CONFIGS, JobConfig

__all__ = ["run_gate", "GATE_RUNNERS"]


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _frame_size(cfg: JobConfig, scale):
    return (max(64, int(cfg.render.width * scale)),
            max(36, int(cfg.render.height * scale)))


def gate1_cube_occupancy(cfg: JobConfig, scale=1.0, check_oracle=True,
                         device=None):
    """cube -> voxelgridBool, CPU-checkable occupancy, no render."""
    v, f = meshes.make_scene_mesh(cfg.mesh)
    vs = cfg.voxelize.voxel_size / scale
    grid = GridBool.from_mesh(v, f, vs, device=device)
    occ = _np(grid.occupancy()).astype(bool)
    out = {"dims": grid.dims, "occupied": int(occ.sum()),
           "set_calls": grid.set_calls}
    if check_oracle:
        ref = oracle_voxelize(v, f, vs)
        out["bit_exact"] = bool(np.array_equal(occ, ref.occupancy))
        out["set_calls_match"] = grid.set_calls == ref.set_calls
    return out


def gate2_bunny_render(cfg: JobConfig, scale=1.0, device=None):
    """bunny -> AABB-struct + primary-ray hit/miss render, flat shading."""
    v, f = meshes.make_scene_mesh(cfg.mesh)
    vs = cfg.voxelize.voxel_size / scale
    grid = build_grid("aabbstruct", v, f, vs, device=device)
    scene = build_scene(models=None, grid={
        "occ": grid.occupancy(), "dims": grid.dims, "origin": grid.origin,
        "voxel_size": grid.voxel_size}, device=device)
    w, h = _frame_size(cfg, scale)
    img = _np(render_scene(scene, Camera(), width=w, height=h,
                           backend=cfg.render.backend))
    return {"dims": grid.dims, "image_shape": img.shape,
            "image_mean": float(img.mean()),
            "hit_fraction": float(
                (np.abs(img[..., 2] - img[..., 0]) > 1e-3).mean())}


def gate3_vec_octree_aov(cfg: JobConfig, scale=1.0, device=None):
    """vec encoding + octree-backed traversal, depth+normal output."""
    if cfg.render.backend != "octree":
        raise ValueError(
            f"gate 3 must exercise the octree walk, got backend="
            f"{cfg.render.backend!r}")
    v, f = meshes.make_scene_mesh(cfg.mesh)
    vs = cfg.voxelize.voxel_size / scale
    gvec = build_grid("vec", v, f, vs, device=device)
    tree = build_grid("octree", v, f, vs, device=device)
    # the octree is the acceleration structure: backend "octree" walks
    # it; the vec encoding provides the AABB list (the same geometry)
    scene = build_scene(models=None, grid={
        "occ": tree.occupancy(), "dims": tree.dims,
        "origin": tree.root_min, "voxel_size": tree.voxel_size},
        aabbs=gvec.get_aabbs(), octree=tree, device=device)
    w, h = _frame_size(cfg, scale)
    depth, normal, hit = (_np(x) for x in render_aov(
        scene, Camera(), width=w, height=h, backend=cfg.render.backend))
    finite = np.isfinite(depth)
    return {"vec_aabbs": int(gvec.aabbs.shape[0]),
            "octree_nodes": tree.n_nodes,
            "backend": cfg.render.backend,
            "hit_pixels": int(hit.sum()),
            "depth_min": float(depth[finite].min()) if finite.any()
            else None,
            "normals_unit": bool(np.allclose(
                np.linalg.norm(normal[hit], axis=-1), 1.0, atol=1e-5))
            if hit.any() else None}


def gate4_flythrough(cfg: JobConfig, scale=1.0, frames=None, device=None):
    """large mesh -> high-res grid, shadowed render, camera fly-through."""
    v, f = meshes.make_scene_mesh(cfg.mesh)
    vs = cfg.voxelize.voxel_size / scale
    grid = GridBool.from_mesh(v, f, vs, device=device)
    scene = build_scene(models=None, grid=grid, device=device)
    w, h = _frame_size(cfg, scale)
    n_frames = frames or cfg.render.frames
    bb_min, bb_max = mesh_bbox(v)
    center = tuple(((bb_min + bb_max) * 0.5).tolist())
    radius = float(np.max(bb_max - bb_min)) * 1.2
    stats = []
    for cam in orbit_path(n_frames, center=center, radius=radius,
                          height=center[1] + radius * 0.3):
        img = render_scene(scene, cam, width=w, height=h,
                           backend=cfg.render.backend)
        stats.append(float(img.mean()))
    return {"dims": grid.dims, "frames": n_frames, "frame_means": stats}


def gate5_deforming(cfg: JobConfig, scale=1.0, frames=None, n_devices=None,
                    device=None):
    """per-frame re-voxelization of a deforming mesh, the frames dealt over
    a mesh of n_devices devices: CUDA devices (all by default), or with
    device="cpu" a rehearsal mesh of n_devices (default 1) CPU entries.
    Besides JAX's keys it returns the grid (`origin`, `voxel_size`), the
    occupancy (F, Z, Y, X) uint8 and the per-frame set_calls, on the
    mesh's first device."""
    if device is not None and torch.device(device).type != "cuda":
        mesh = make_mesh(devices=[device] * (n_devices or 1))
    else:
        mesh = make_mesh(n_devices)
    v, f = meshes.make_scene_mesh(cfg.mesh)
    vs = cfg.voxelize.voxel_size / scale
    n_frames = frames or cfg.render.frames
    # one grid for the whole animation: the bbox of every frame
    fv = np.stack([meshes.deformed(v, 2 * np.pi * i / n_frames)
                   for i in range(n_frames)])
    bb_min, bb_max = mesh_bbox(fv.reshape(-1, 3))
    dims = grid_dims(bb_min, bb_max, vs)
    occ, calls = voxelize_frames_sharded(fv, f, bb_min, mesh, dims=dims,
                                         voxel_size=vs)
    counts = [int(c) for c in occ.reshape(n_frames, -1).sum(dim=1,
                                                           dtype=torch.int64)]
    return {"dims": dims, "devices": mesh.size, "frames": n_frames,
            "occupied_per_frame": counts, "origin": bb_min,
            "voxel_size": vs, "occupancy": occ,
            "set_calls_per_frame": calls.tolist()}


GATE_RUNNERS = {
    "cube64": gate1_cube_occupancy,
    "bunny128": gate2_bunny_render,
    "vec256": gate3_vec_octree_aov,
    "knot512": gate4_flythrough,
    "deform8": gate5_deforming,
}


def run_gate(name: str, scale: float = 1.0, device=None, **kw):
    """Execute one BASELINE gate config on `device` (default: the CUDA
    card; device="cpu" runs the plain versions); scale < 1 shrinks it."""
    cfg = BASELINE_CONFIGS[name]
    return GATE_RUNNERS[name](cfg, scale=scale, device=device, **kw)
