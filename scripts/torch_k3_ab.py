#!/usr/bin/env python3
"""K3 grid_walk of two source trees, timed in turns on one card.

Each tree is a checkout of this repository (this one, and another commit
unpacked with `git archive` into a directory that .gitignore lists).
For each tree in the order A, B, B, A a child process imports that
tree's voxelray_torch, builds its kernel library, builds chip_smoke.py's
voxel scene (the 1,048,576-triangle torus knot at 512^3) and the bench
camera's 1920x1080 rays in render_image's tile order, and times K3 with
CUDA events on the staged walk's two inputs that chip_smoke.py checks:
round 1 (fused init, k 5, every ray) and the resume (k 8, the rays that
go on).  Each run prints one JSON line: the tree, the mean ms of REPS
calls ROUNDS times over, a checksum of the outputs (equal across trees
when their kernels agree) and ptxas's report for grid_walk_kernel.  The
card's name and power limit come last.

    python3 scripts/torch_k3_ab.py TREE_A TREE_B [OUT.json]

Needs one CUDA device and nvcc; imports no JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

MESH = dict(p=2, q=3, segments=1024, tube_segments=512)
GRID_RES = 512
WIDTH, HEIGHT = 1920, 1080
REPS, ROUNDS = 50, 5


def ptxas_report(log, kernel):
    """ptxas's lines (registers, spills) for the entry function whose
    name holds `kernel`."""
    out, inside = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            inside = kernel in ln
        elif inside and ("registers" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def child(tree):
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch
    import voxelray_torch
    from voxelray_torch.io import meshes
    from voxelray_torch.models.grids import GridBool
    from voxelray_torch.models.scene import build_scene
    from voxelray_torch.ops import geometry
    from voxelray_torch.ops.intersect import TMAX, TMIN, make_camera_rays
    from voxelray_torch.ops.kernels import _build, grid_walk
    from voxelray_torch.render import pipeline
    from voxelray_torch.render.camera import Camera

    pkg = Path(voxelray_torch.__file__).resolve()
    if Path(tree).resolve() not in pkg.parents:
        raise RuntimeError(f"imported {pkg}, not the package of {tree}")
    dev = torch.device("cuda", 0)
    _build.load_library()
    v, f = meshes.torus_knot(**MESH)
    bb_min, bb_max = geometry.mesh_bbox(v)
    vs = float(max(bb_max - bb_min)) / GRID_RES
    extent = float(max(bb_max - bb_min))
    center = (bb_min + bb_max) * 0.5
    cam = Camera(eye=tuple(center + np.asarray([0.9, 0.55, -0.9]) * extent),
                 center=tuple(center))
    _, _, vi, pi = cam.matrices(WIDTH, HEIGHT)
    accel = build_scene(grid=GridBool.from_mesh(v, f, vs, device=dev),
                        device=dev).accel
    o, d = make_camera_rays(WIDTH, HEIGHT, vi, pi, device=dev)
    o = pipeline._tile_rays(o, HEIGHT, WIDTH).contiguous()
    d = pipeline._tile_rays(d, HEIGHT, WIDTH).contiguous()
    n = o.shape[0]
    tmn = torch.full((n,), float(TMIN), device=dev)
    tmx = torch.full((n,), float(TMAX), device=dev)
    kw = dict(bdims=accel.bdims, origin_key=accel.origin_key,
              brick_world=float(accel.voxel_size * 8))
    l2 = accel.l2
    first = (o, d, tmn, tmx, None, None, accel.coarse, l2)
    hits, cell, cont = grid_walk.walk_cuda(*first, **kw, k_hits=5)
    go = torch.nonzero(cont > 0).squeeze(1)
    resume = (o[go], d[go], None, tmx[go], cell[go].contiguous(),
              torch.ones_like(go, dtype=torch.int32), accel.coarse, l2)
    hits2, cell2, cont2 = grid_walk.walk_cuda(*resume, **kw, k_hits=8)
    torch.cuda.synchronize()

    def timed(args, k):
        grid_walk.walk_cuda(*args, **kw, k_hits=k)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPS):
            grid_walk.walk_cuda(*args, **kw, k_hits=k)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    ms = {"round 1, k 5": [], "resume, k 8": []}
    for _ in range(ROUNDS):
        ms["round 1, k 5"].append(timed(first, 5))
        ms["resume, k 8"].append(timed(resume, 8))
    print(json.dumps({
        "tree": str(tree), "rays": [n, int(go.numel())], "ms": ms,
        "checksum": [int(x.long().sum()) for x in (hits, cell, cont, hits2,
                                                   cell2, cont2)],
        "ptxas_grid_walk_kernel": ptxas_report(_build.build_log(),
                                               "grid_walk_kernel")}))
    return 0


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        return child(sys.argv[2])
    if len(sys.argv) not in (3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("torch_k3_ab: no CUDA device", file=sys.stderr)
        return 2
    a, b = sys.argv[1], sys.argv[2]
    rows = []
    for tree in (a, b, b, a):
        proc = subprocess.run([sys.executable, __file__, "--child", tree],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        rows.append(row)
    sums = {json.dumps(r["checksum"]) for r in rows}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"outputs equal across trees: {len(sums) == 1}")
    print(f"card: {smi}")
    if len(sys.argv) == 4:
        out = Path(sys.argv[3]).resolve()
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"runs": rows, "card": smi}, indent=1))
    return 0 if len(sums) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
