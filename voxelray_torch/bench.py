"""Headline benchmark of the port: bench.py's measurements and gates.

A port of bench.py (the JAX package's benchmark), section by section: a
1,048,576-triangle torus knot voxelized to 512^3 through a VoxelizePlan
(K1), the AABB extraction and grid bytes of the reference Benchmaker
triple (hello_vulkan.h:224-239), the dispatch floor, the triple's
pipelined form, 1920x1080 frames one call at a time and pipelined over
orbit cameras (K2; with BENCH_MEGA=0 the staged walk, one staged_march
launch a trace), the small-scene parity gate and the full-size
exhaustiveness gate.  Prints ONE JSON line on stdout, detail on stderr:

    python -m voxelray_torch.bench

Env knobs (bench.py's):
  BENCH_PRESET=full|mid|small   scene scale (default full)
  BENCH_RUNS=N                  timed repetitions (default 5)
  BENCH_BACKEND=fast|dda|brute  traversal backend (default fast)
  BENCH_SKIP_PARITY=1           skip the parity and exhaustiveness gates
  BENCH_MEGA=0                  the staged walk (staged_march: K3's and
                                K4's walks in one launch) in place of K2

The line has bench.py's keys with these changes.  The port has one
voxelizer, K1: its in-bench gate holds the planned occupancy and
set_calls to voxelize_plain and reports `voxelize_plain_exact` in
`parity`, so `voxelize_scatter_ms` is not emitted and `voxelize_path`
reads "k1".  `vs_baseline` is dropped: BASELINE.json's 100 Mrays/s is a
target stated for a TPU.  Added: `gpu` and `power_limit` (nvidia-smi)
and `launches`, each kernel's launches over one pipelined pass of
shadowed frames.  Times are seconds of the host clock around work that
ends in a device sync, reported in ms.

The bench runs on the card and raises without one; run(device="cpu")
runs the plain versions.  A failed gate prints the line with parity_ok
false and exits 1; an exception exits nonzero without a line.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .io import meshes
from .models.grids import GridBool
from .models.scene import build_scene
from .ops import aabbs as ops_aabbs
from .ops.geometry import grid_dims, mesh_bbox
from .ops.intersect import make_camera_rays
from .ops.traverse import trace_grid_dda_chunked
from .ops.traverse_fast import trace_grid_fast
from .ops.voxelize import plan_voxelize, voxelize_plain, voxelize_planned
from .oracle import oracle_voxelize
from .render.camera import Camera, orbit_path
from .render.pipeline import render_aov, render_image, render_scene
from .utils import trace
from .utils.device import resolve_device
from .utils.parity import adjudicate_hit_diffs
from .utils.timing import time_fn

__all__ = ["run", "main", "parity_gate", "exhaustive_gate"]

# bench.py:208-216: torus_knot(p, q, segments, tube_segments), grid
# resolution, frame width and height
PRESETS = {
    "small": ((2, 3, 128, 64), 128, 640, 360),
    "mid": ((2, 3, 512, 256), 256, 1280, 720),
    "full": ((2, 3, 1024, 512), 512, 1920, 1080),
}
# the parity gate's scene (bench.py:136-148): icosphere subdivisions,
# voxel size, frame, camera eye
PARITY_MESH, PARITY_VS = 3, 2.2 / 64
PARITY_W, PARITY_H = 320, 180
PARITY_EYE = (2.1, 1.4, -2.2)
KP = 6                  # pipelined voxelize / extract calls per sync
MAX_DIFF_RAYS = 2048    # more differing rays than this is a bug, not FMA
KERNELS = ("voxel_accum", "mega_trace", "grid_walk", "brick_fine",
           "tri_march", "staged_march", "camera_rays", "hit_surface",
           "shade_post")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches():
    return {name: trace.counter(f"launches.{name}") for name in KERNELS}


def _smi(device):
    """(name, power limit) of the card as nvidia-smi reports them; (None,
    None) off the card."""
    if device.type != "cuda":
        return None, None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


def _pipelined(calls, device):
    """(best seconds per call over two passes of the calls queued back to
    back with one sync, the launches of the warm-up pass before them)."""
    def one_pass():
        t0 = time.perf_counter()
        for call in calls:
            call()
        _sync(device)
        return (time.perf_counter() - t0) / len(calls)

    before = _launches()
    one_pass()
    after = _launches()
    return (min(one_pass(), one_pass()),
            {k: after[k] - before[k] for k in after})


def parity_gate(device):
    """Small-scene cross-backend and oracle parity on `device`
    (bench.py:122-181): K1 against oracle_voxelize, the fast and brute
    AOVs against dda's, and the shadowed image fast against dda."""
    checks = {}
    v, f = meshes.icosphere(PARITY_MESH)
    grid = GridBool.from_mesh(v, f, PARITY_VS, device=device)
    ref = oracle_voxelize(v, f, PARITY_VS)
    occ = grid.occupancy().cpu().numpy().astype(bool)
    checks["occupancy_bit_exact"] = bool(np.array_equal(occ, ref.occupancy))
    checks["set_calls_match"] = bool(grid.set_calls == ref.set_calls)

    scene = build_scene(grid=grid, device=device)
    cam = Camera(eye=PARITY_EYE, center=(0.0, 0.0, 0.0))
    outs = {}
    for backend in ("fast", "dda", "brute"):
        depth, _, hit = render_aov(scene, cam, width=PARITY_W,
                                   height=PARITY_H, backend=backend)
        outs[backend] = (depth.cpu().numpy(), hit.cpu().numpy())
    dd, hd = outs["dda"]
    for backend in ("fast", "brute"):
        db, hb = outs[backend]
        both = hb & hd
        checks[f"{backend}_hits_match_dda"] = bool(np.array_equal(hb, hd))
        checks[f"{backend}_t_match_dda"] = bool(np.allclose(
            db[both], dd[both], rtol=2e-6, atol=0.0)) if both.any() else True
    checks["hit_pixels"] = int(hd.sum())

    imgs = {b: render_scene(scene, cam, width=PARITY_W, height=PARITY_H,
                            backend=b, shadows=True).cpu().numpy()
            for b in ("fast", "dda")}
    close = np.isclose(imgs["fast"], imgs["dda"], rtol=2e-5, atol=1e-6)
    frac = float(close.all(axis=-1).mean())
    checks["shadow_image_match_frac"] = frac
    checks["shadow_image_ok"] = bool(frac >= 0.999)
    ok = all(x for x in checks.values() if isinstance(x, bool))
    log(f"parity gate: {checks}")
    return ok, checks


def exhaustive_gate(scene, vi, pi, width, height, mega, device):
    """The fast trace against the exhaustive DDA on the headline frame's
    rays (bench.py:434-501): hit masks and cells equal and unresolved 0,
    or every differing ray (at most MAX_DIFF_RAYS) adjudicated against
    the numpy oracle."""
    o, d = make_camera_rays(width, height, vi, pi, device=device)
    t_f, lin_f, unresolved = trace_grid_fast(o, d, scene.accel, mega=mega,
                                             return_stats=True)
    t_d, lin_d = trace_grid_dda_chunked(
        o, d, scene.occ_flat, scene.grid_origin, dims=scene.grid_dims,
        voxel_size=scene.grid_voxel_size)
    t_f, lin_f, t_d, lin_d = (x.reshape(-1).cpu().numpy()
                              for x in (t_f, lin_f, t_d, lin_d))
    hf, hd = np.isfinite(t_f), np.isfinite(t_d)
    out = {"fast_hits": int(hf.sum()), "dda_hits": int(hd.sum()),
           "unresolved": int(unresolved),
           "hits_equal": bool(np.array_equal(hf, hd)),
           "cells_equal": bool(np.array_equal(lin_f[hf & hd],
                                              lin_d[hf & hd]))}
    out["exhaustive_ok"] = (out["hits_equal"] and out["cells_equal"]
                            and out["unresolved"] == 0)
    if not out["exhaustive_ok"] and out["unresolved"] == 0:
        idx = np.flatnonzero((hf != hd) | (hf & hd & (lin_f != lin_d)))
        if len(idx) <= MAX_DIFF_RAYS:
            nx, ny, nz = scene.grid_dims
            adj = adjudicate_hit_diffs(
                o.reshape(-1, 3).cpu().numpy(),
                d.reshape(-1, 3).cpu().numpy(),
                scene.occ_flat.reshape(nz, ny, nx).cpu().numpy() > 0,
                scene.grid_origin.cpu().numpy(), scene.grid_voxel_size, idx,
                t_f, lin_f, t_d, lin_d)
            out.update(adj)
            out["exhaustive_ok"] = adj["adjudication_ok"]
    log(f"full-scale exhaustiveness: {out}")
    return out


def run(device=None, preset="full", runs=5, backend="fast", mega=True,
        skip_parity=False):
    """The bench on `device` (default: the CUDA card); returns the JSON
    line's dict."""
    device = resolve_device(device)
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}")
    knot, grid_res, width, height = PRESETS[preset]
    gpu, power_limit = _smi(device)
    log(f"device={device} gpu={gpu} power_limit={power_limit} "
        f"preset={preset}")
    v, f = meshes.torus_knot(*knot)
    bb_min, bb_max = mesh_bbox(v)
    extent = float(max(bb_max - bb_min))
    vs = extent / grid_res
    dims = grid_dims(bb_min, bb_max, vs)
    log(f"mesh: {len(f)} tris, dims {dims}, voxel {vs:.5f}")

    # ---- voxelize: the plan once (host), then timed K1 launches; the
    # warm-up call absorbs the kernels' build
    plan = plan_voxelize(v, f, vs, bb_min=bb_min, bb_max=bb_max,
                         device=device)
    log("plan buckets: " + ", ".join(
        f"{win}x{len(fi)}" for win, fi in plan.buckets))
    v_dev = torch.as_tensor(v, device=device)
    t_build, occ = time_fn(lambda: voxelize_planned(plan, v_dev)[0],
                           iters=max(1, runs // 2), warmup=1)
    n_occ = int(occ.sum())
    log(f"voxelize: {t_build * 1e3:.3f} ms "
        f"({len(f) / t_build / 1e6:.2f} Mtris/s), {n_occ} occupied")

    # in-bench gate: K1's planned result against the plain version on the
    # same device; its ~1 GB of temporaries are released before the frames
    occ_p, calls_p = voxelize_plain(v_dev, plan.faces, plan.origin, vs, dims)
    calls_k = int(voxelize_planned(plan, v_dev)[1])
    vox_exact = bool(torch.equal(occ_p, occ)) and calls_p == calls_k
    del occ_p
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"voxelize_planned vs voxelize_plain: exact={vox_exact}, "
        f"set_calls {calls_k} / {calls_p}")

    # ---- AABB extraction + grid bytes, capacities as bench.py:296-304
    grid = GridBool.from_occupancy(occ, bb_min, vs)
    wcap = -(-int(ops_aabbs.count_nonzero_words(occ) * 1.1) // 8192) * 8192
    gcap = -(-int(ops_aabbs.count_nonzero_groups(occ) * 1.1) // 8192) * 8192

    def extract():
        return grid.get_aabbs_fixed(capacity=1 << 20, word_capacity=wcap,
                                    group_capacity=gcap)

    t_extract, _ = time_fn(extract, iters=max(1, runs // 2), warmup=1)
    mem_bytes = grid.memory_usage_bytes()
    # the dispatch floor: one trivial op on the grid words, synced
    t_floor, _ = time_fn(lambda: grid.words[:1].clone(), iters=3, warmup=1)
    log(f"aabb extract: {t_extract * 1e3:.3f} ms, grid {mem_bytes} bytes "
        f"(dispatch floor {t_floor * 1e3:.4f} ms)")

    # ---- the pipelined triple: KP calls, one sync.  No fresh input
    # copies: CUDA does not coalesce identical calls
    t_build_pipe, _ = _pipelined(
        [lambda: voxelize_planned(plan, v_dev)] * KP, device)
    t_extract_pipe, _ = _pipelined([extract] * KP, device)
    log(f"pipelined triple: voxelize {t_build_pipe * 1e3:.3f} ms, extract "
        f"{t_extract_pipe * 1e3:.3f} ms")

    # ---- frames, one call at a time
    scene = build_scene(grid=grid, device=device)
    mega_on = bool(mega and backend == "fast" and scene.accel is not None
                   and scene.accel.fine_sb is not None)
    ropts = (dict(fast_opts={"mega": mega_on}, shadow_opts={"mega": mega_on})
             if backend == "fast" else {})
    log(f"mega traversal: {mega_on}")
    center = (bb_min + bb_max) * 0.5
    cam = Camera(eye=tuple(center + np.asarray([0.9, 0.55, -0.9]) * extent),
                 center=tuple(center))
    _, _, vi, pi = cam.matrices(width, height)
    frame = functools.partial(render_image, width=width, height=height,
                              backend=backend, **ropts)
    t_render_lat, img = time_fn(frame, scene, vi, pi, iters=runs, warmup=1)
    t_prim_lat, _ = time_fn(frame, scene, vi, pi, shadows=False, iters=runs,
                            warmup=1)

    # ---- pipelined frames over orbit cameras, one sync (the headline)
    k_frames = max(4, runs * 2)
    r_orbit = float(np.linalg.norm(np.asarray([0.9, 0.55, -0.9]) * extent))
    cams = orbit_path(k_frames, center=tuple(float(c) for c in center),
                      radius=r_orbit, height=float(center[1] + 0.55 * extent))
    mats = [c.matrices(width, height)[2:] for c in cams]
    t_render, launches = _pipelined(
        [functools.partial(frame, scene, cvi, cpi) for cvi, cpi in mats],
        device)
    mrays = width * height / t_render / 1e6
    log(f"render (pipelined x{k_frames}): {t_render * 1e3:.3f} ms/frame -> "
        f"{mrays:.1f} Mrays/s (latency {t_render_lat * 1e3:.3f} ms; img "
        f"mean {float(img.mean()):.3f}); launches a pass {launches}")
    t_prim, _ = _pipelined(
        [functools.partial(frame, scene, cvi, cpi, shadows=False)
         for cvi, cpi in mats], device)
    prim_mrays = width * height / t_prim / 1e6
    log(f"primary-only (pipelined): {t_prim * 1e3:.3f} ms/frame -> "
        f"{prim_mrays:.1f} Mrays/s (latency {t_prim_lat * 1e3:.3f} ms)")

    # ---- gates
    parity = {"voxelize_plain_exact": vox_exact}
    if skip_parity:
        parity_ok = None if vox_exact else False
    else:
        gate_ok, checks = parity_gate(device)
        exhaustive = exhaustive_gate(scene, vi, pi, width, height, mega_on,
                                     device)
        parity.update(checks)
        parity.update(exhaustive)
        parity_ok = vox_exact and gate_ok and exhaustive["exhaustive_ok"]

    return {
        "metric": f"primary-ray Mrays/s @{width}x{height}, "
                  f"{grid_res}^3 grid, {len(f)} tris",
        "value": prim_mrays,
        "unit": "Mrays/s",
        "voxelize_ms": t_build * 1e3,
        "voxelize_mtris_per_s": len(f) / t_build / 1e6,
        "voxelize_path": "k1",
        "render_ms": t_render * 1e3,
        "shadowed_mrays_s": mrays,
        "primary_mrays_s": prim_mrays,
        "primary_render_ms": t_prim * 1e3,
        "render_latency_ms": t_render_lat * 1e3,
        "primary_latency_ms": t_prim_lat * 1e3,
        "pipelined_frames": k_frames,
        "aabb_extract_ms": t_extract * 1e3,
        "voxelize_pipelined_ms": t_build_pipe * 1e3,
        "aabb_extract_pipelined_ms": t_extract_pipe * 1e3,
        "dispatch_floor_ms": t_floor * 1e3,
        "grid_bytes": int(mem_bytes),
        "occupied_voxels": n_occ,
        "backend": backend,
        "mega": mega_on,
        "preset": preset,
        "parity_ok": parity_ok,
        "parity": parity,
        "gpu": gpu,
        "power_limit": power_limit,
        "launches": launches,
    }


def main(device=None):
    """Read bench.py's env knobs, run, print the JSON line; 1 if a gate
    failed, else 0."""
    res = run(device, preset=os.environ.get("BENCH_PRESET", "full"),
              runs=int(os.environ.get("BENCH_RUNS", "5")),
              backend=os.environ.get("BENCH_BACKEND", "fast"),
              mega=os.environ.get("BENCH_MEGA", "1") != "0",
              skip_parity=bool(os.environ.get("BENCH_SKIP_PARITY")))
    print(json.dumps(res), flush=True)
    return 1 if res["parity_ok"] is False else 0


if __name__ == "__main__":
    sys.exit(main())
