#!/usr/bin/env python3
"""The multi-device layer of voxelray_torch on every card of the machine.

chip_smoke.py holds parallel/comm.py on one card, through a rehearsal
mesh (the one card repeated) and make_mesh().  This script runs the same
paths on make_mesh(), every card, where each shard's work and each
gather cross devices, at chip_smoke.py's full size (the 1,048,576-
triangle knot at 512^3, the bench camera at 1920x1080, shadows on), and
times each beside the one-card mesh and the rehearsal mesh of as many
entries on one card:

  * voxelize_sharded of the knot less one triangle: occupancy and
    set_calls bit-equal to K1 alone, K1 launched once per card;
  * render_sharded (backend fast): the frame within rtol 2e-6 / atol
    1e-7 of render_image's, K2 launched on every card;
  * render_zslab_sharded (backend fast), the grid in one Z-slab per
    card: the merged primary trace bit-equal to the monolithic staged
    walk's, the frame against render_image through the staged walk, one
    staged_march launch per slab trace; the slabs' primary traces alone
    (ZSlabs.per_slab: on distinct cards they run at once) beside the
    first slab's trace alone;
  * the DDA Z-slab render at gate 2's bunny (128^3, 1280x720);
  * gate 5 through make_mesh(), bit-equal to its frames on one card.

    python3 scripts/torch_multicard.py [OUT.json]

Prints the card's name and power limit and, last, one JSON line with
the times (wall ms, host clock with the devices synchronized).  Needs at
least two CUDA devices and nvcc; imports no JAX.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def sync_all():
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def wall_ms(fn, reps=3):
    """Mean wall ms of fn() over reps calls after a warm-up, every
    device synchronized."""
    fn()
    sync_all()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync_all()
    return (time.perf_counter() - t0) * 1e3 / reps


def main():
    import torch
    if torch.cuda.device_count() < 2:
        print("torch_multicard: needs at least two CUDA devices",
              file=sys.stderr)
        return 2
    from voxelray_torch.io import meshes
    from voxelray_torch.models.grids import GridBool
    from voxelray_torch.models.scene import build_scene
    from voxelray_torch.ops import geometry
    from voxelray_torch.ops.intersect import TMAX, TMIN, make_camera_rays
    from voxelray_torch.ops.kernels import (brick_fine, grid_walk,
                                            mega_trace, staged_march,
                                            voxel_accum)
    from voxelray_torch.ops.traverse_fast import trace_grid_fast
    from voxelray_torch.parallel import comm
    from voxelray_torch.render import pipeline

    dev = torch.device("cuda", 0)
    smi = cs.smi_line()
    cards = comm.make_mesh()
    n = cards.size
    meshes_ = {f"make_mesh() ({n} cards)": cards,
               "make_mesh(1)": comm.make_mesh(1),
               f"rehearsal mesh of {n} on one card":
               comm.make_mesh(devices=[dev] * n)}
    v, f = meshes.torus_knot(**cs.MESH)
    bb_min, bb_max = geometry.mesh_bbox(v)
    vs = float(max(bb_max - bb_min)) / cs.GRID_RES
    cam, _ = cs.bench_camera(bb_min, bb_max)
    _, _, vi, pi = cam.matrices(cs.WIDTH, cs.HEIGHT)
    grid = GridBool.from_mesh(v, f, vs, device=dev)
    scene = build_scene(grid=grid, device=dev)
    out = {"card": smi, "cards": n, "wall_ms": {}}
    ms = out["wall_ms"]

    v_t = torch.as_tensor(v, device=dev)
    f_t = torch.as_tensor(f, device=dev)
    k1_ms = cs.cuda_ms(lambda: voxel_accum.voxel_accum_cuda(
        v_t, f_t, grid.origin, vs, grid.dims), 5)
    cs.check_voxelize_sharded(v, f, grid.origin, vs, grid.dims,
                              tuple(meshes_.items()), k1_ms, smi)
    tri = v[f[:-1]]
    for name, mesh in meshes_.items():
        ms[f"voxelize_sharded, {name}"] = wall_ms(
            lambda: comm.voxelize_sharded(tri, grid.origin, mesh,
                                          dims=grid.dims, voxel_size=vs))

    kw = dict(width=cs.WIDTH, height=cs.HEIGHT, shadows=True)
    ref = pipeline.render_image(scene, vi, pi, backend="fast", **kw)
    ms["render_image"] = wall_ms(lambda: pipeline.render_image(
        scene, vi, pi, backend="fast", **kw))
    for name, mesh in meshes_.items():
        cs.reset(mega_trace)
        img = comm.render_sharded(scene, vi, pi, mesh, backend="fast", **kw)
        sync_all()
        cs.require(cs.launched(mega_trace) >= 2 * mesh.size,
                   f"render_sharded on {name}: {cs.launched(mega_trace)} K2 "
                   "launches")
        cs.frames_close(f"render_sharded, {name}, vs render_image", img,
                        ref)
        ms[f"render_sharded, {name}"] = wall_ms(lambda: comm.render_sharded(
            scene, vi, pi, mesh, backend="fast", **kw))

    staged = dict(fast_opts={"mega": False}, shadow_opts={"mega": False})
    ref = pipeline.render_image(scene, vi, pi, backend="fast", **staged,
                                **kw)
    ms["render_image, staged walk"] = wall_ms(lambda: pipeline.render_image(
        scene, vi, pi, backend="fast", **staged, **kw))
    o, d = (pipeline._tile_rays(x, cs.HEIGHT, cs.WIDTH).contiguous()
            for x in make_camera_rays(cs.WIDTH, cs.HEIGHT, vi, pi,
                                      device=dev))
    t_s, lin_s = trace_grid_fast(o, d, scene.accel, mega=False)
    for name, mesh in meshes_.items():
        zs = comm.split_zslabs(scene, mesh, "fast")
        t_z, lin_z = zs.trace(o, d)
        cs.require(bool(torch.equal(lin_z, lin_s))
                   and bool(torch.equal(t_z, t_s)),
                   f"Z-slab trace on {name} differs from the staged walk")
        cs.reset(staged_march, grid_walk, brick_fine)
        img = comm.render_zslab_sharded(scene, vi, pi, mesh,
                                        backend="fast", **kw)
        sync_all()
        counts = cs.counts_of(staged_march, grid_walk, brick_fine)
        cs.require(counts["staged_march"] > 0 and counts["grid_walk"] == 0
                   and counts["brick_fine"] == 0,
                   f"Z-slab frame on {name}: not through staged_march")
        cs.frames_close(f"Z-slab frame, {name}, vs render_image (staged "
                        "walk)", img, ref)
        ms[f"split_zslabs, {name}"] = wall_ms(
            lambda: comm.split_zslabs(scene, mesh, "fast"))
        ms[f"Z-slab merged primary trace, {name}"] = wall_ms(
            lambda: zs.trace(o, d))
        ms[f"Z-slab per-slab primary traces, {name}"] = wall_ms(
            lambda: zs.per_slab(o, d, TMIN, TMAX))
        ms[f"Z-slab first slab's primary trace alone, {name}"] = wall_ms(
            lambda: trace_grid_fast(o, d, zs.slabs[0]))
        ms[f"render_zslab_sharded, {name}"] = wall_ms(
            lambda: comm.render_zslab_sharded(scene, vi, pi, mesh,
                                              backend="fast", **kw))
        cs.log(f"Z-slab, {name}: {zs.mesh.size} slabs of {zs.nzs} rows, "
               f"merged trace bit-equal to the staged walk, frame launches "
               f"{counts} [{smi}]")

    cs.check_zslab_dda(dev, cards, smi)
    cs.check_gate5_mesh(dev, comm.make_mesh(1), smi)
    for k, x in ms.items():
        cs.log(f"{k}: {x:.3f} ms wall (mean of 3) [{smi}]")
    text = json.dumps(out)
    if len(sys.argv) > 1:
        path = Path(sys.argv[1])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    print(smi)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
