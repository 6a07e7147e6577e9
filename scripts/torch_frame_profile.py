#!/usr/bin/env python3
"""Where the time of a 1920x1080 frame goes, for the PyTorch/CUDA port.

Builds the bench scenes of chip_smoke.py (the 1,048,576-triangle torus
knot as a 512^3 voxel grid and as a triangle model) and, for each frame
kind (voxel with the megakernel K2, voxel with the staged walk through
the staged_march kernel and through the lap loop over K3 + K4 that it
replaced, triangles through the tri_march kernel, and triangles through
the lap loop over K3 + K4 that the kernel replaced), records one warm
frame with torch.profiler: wall ms, device busy ms (the union of the
kernels' intervals), the device's idle share, launches by kernel name,
and the port's kernel launch counters.  Prints one JSON line per frame
kind and, given a path, also writes them all there as one JSON list.

    python3 scripts/torch_frame_profile.py [OUT.json]

Needs one CUDA device and nvcc; imports no JAX.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WIDTH, HEIGHT = 1920, 1080
TOP = 12


def busy_ms(events):
    """Union length of the device intervals of the profiled kernels."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3                                  # us -> ms


def profile_frame(render, kmods):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from voxelray_torch.utils import trace
    names = [m.__name__.rsplit(".", 1)[-1] for m in kmods]
    render()                                            # warm
    torch.cuda.synchronize()
    for name in names:
        trace.reset_counters(f"launches.{name}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms(kernels)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + (e.time_range.end
                                       - e.time_range.start) / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall if wall else None,
            "device_launches": len(kernels),
            "port_kernel_launches": {n: trace.counter(f"launches.{n}")
                                     for n in names},
            "top_kernels": [{"name": k[:80], "count": n, "ms": t}
                            for k, (n, t) in top]}


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_frame_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from chip_smoke import (bench_camera, knot_model, lap_loop_march,
                            lap_loop_staged, MESH, GRID_RES)
    from voxelray_torch.io import meshes
    from voxelray_torch.models.grids import GridBool
    from voxelray_torch.models.scene import build_scene
    from voxelray_torch.ops import geometry
    from voxelray_torch.ops.kernels import (brick_fine, grid_walk,
                                            mega_trace, staged_march,
                                            tri_march, voxel_accum)
    from voxelray_torch.render.pipeline import render_image

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    kmods = (voxel_accum, mega_trace, grid_walk, brick_fine, tri_march,
             staged_march)
    v, f = meshes.torus_knot(**MESH)
    bb_min, bb_max = geometry.mesh_bbox(v)
    vs = float(max(bb_max - bb_min)) / GRID_RES
    cam, _ = bench_camera(bb_min, bb_max)
    _, _, vi, pi = cam.matrices(WIDTH, HEIGHT)
    vox = build_scene(grid=GridBool.from_mesh(v, f, vs))
    tri = build_scene(models=[knot_model(v, f)])
    staged = dict(fast_opts={"mega": False}, shadow_opts={"mega": False})
    kinds = {
        "voxel_mega": (vox, {}, contextlib.nullcontext),
        "voxel_staged": (vox, staged, contextlib.nullcontext),
        "voxel_staged_lap_loop": (vox, staged, lap_loop_staged),
        "triangles": (tri, {}, contextlib.nullcontext),
        "triangles_lap_loop": (tri, {}, lap_loop_march),
    }
    rows = []
    for name, (scene, kw, march) in kinds.items():
        for shadows in (True, False):
            with march():
                res = profile_frame(lambda: render_image(
                    scene, vi, pi, width=WIDTH, height=HEIGHT,
                    backend="fast", shadows=shadows, **kw), kmods)
            res.update(frame=name, shadows=shadows, card=smi)
            print(json.dumps(res), flush=True)
            rows.append(res)
    if len(sys.argv) > 1:
        out = Path(sys.argv[1]).resolve()
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rows, indent=1))
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
