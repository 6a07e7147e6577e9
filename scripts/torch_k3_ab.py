#!/usr/bin/env python3
"""K1, K2, K3, K4 or the voxel frame of two source trees, timed in turns
on one card.

Each tree is a checkout of this repository (this one, and another commit
unpacked with `git archive` into a directory that .gitignore lists).
For each tree in the order A, B, B, A a child process imports that
tree's voxelray_torch, builds its kernel library and chip_smoke.py's
inputs (the 1,048,576-triangle torus knot, voxelized to 512^3, and the
bench camera's 1920x1080 rays in render_image's tile order), and times
one kernel with CUDA events:

  k1  voxel_accum on the knot at 512^3: the wrapper (zeroed volume,
      launch, sync) and the kernel alone;
  k2  mega_trace on the primary rays, on the frame's shadow pass (the
      masked launch over every ray, and its admitted rays compacted),
      and on the primary rays of each step class of
      chip_smoke.k2_step_classes, which a first child on this checkout
      counts (chip_smoke.mega_work) and saves for the others;
  k3  grid_walk on the staged walk's two inputs that chip_smoke.py
      checks: round 1 (fused init, k 5, every ray) and the resume (k 8,
      the rays that go on);
  k4  brick_fine on chip_smoke.py's two inputs (the 512^3 grid's round 1
      candidates, k 5, and the triangle accel's first lap, k 2), and
      tri_march, which shares K4's walk, on the primary rays of the knot
      as a triangle model;
  staged  the staged trace as trace_grid_fast(mega=False) runs it on the
      card (one staged_march launch where the tree has that kernel,
      else the lap loop over K3 and K4) on the primary rays (k 5), on
      the frame's shadow pass as render_image calls it (the admit mask,
      k 4, scalar TMIN), on slab 1 of render_zslab_sharded's four Z-slabs
      (its build_accel_slab accel, k 5), and on the primary rays with the
      most groups (the TOP_STAGED of them, which a first child on this
      checkout finds with scripts/torch_staged_march_laps.py's
      clock-split build and saves for the others) packed as their tile
      order packs them and one to a warp (each followed by 31 rays that
      miss the grid): device ms per call (CUDA events; a tree whose
      staged trace is the lap loop syncs inside it);
  frame  the voxel frame (render_image, backend "fast": K2 for the
      primary and the shadow pass) from the bench camera, shadows on
      and off: wall ms per frame (host clock, synchronized), and one
      frame under torch.profiler for its device launches and busy ms.

Each run prints one JSON line: the tree, the mean ms of REPS calls ROUNDS
times over, a checksum of the outputs (equal across trees when their
kernels agree) and ptxas's report for the kernel.  The card's name and
power limit come last.

    python3 scripts/torch_k3_ab.py [--kernel k1|k2|k3|k4|staged|frame] TREE_A TREE_B [OUT.json]

(k4's tri_march rows: the primary rays and the triangle frame's shadow
rays, hit and facing the light.)

Needs one CUDA device and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
MESH = dict(p=2, q=3, segments=1024, tube_segments=512)
GRID_RES = 512
WIDTH, HEIGHT = 1920, 1080
REPS, ROUNDS = 50, 5
TOP_STAGED = 40
ENTRY = {"k1": ("voxel_accum_kernel",), "k2": ("mega_trace_kernel",),
         "k3": ("grid_walk_kernel",),
         "k4": ("brick_fine_kernel", "tri_march_kernel"),
         "staged": ("staged_march_kernel",),
         "frame": ("mega_trace_kernel",)}


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


def sha(*tensors):
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def timed(fn):
    """ROUNDS means of REPS calls of fn, in device ms (after a warm-up)."""
    import torch
    out = []
    fn()
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / REPS)
    return out


def wall_timed(fn):
    """ROUNDS means of REPS calls of fn, in host ms with the device
    synchronized (for calls that synchronize inside)."""
    import time
    import torch
    out = []
    fn()
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / REPS)
    return out


def bench_camera(v):
    """The bench camera's (view_inv, proj_inv) and the mesh bounds."""
    import numpy as np
    from voxelray_torch.ops import geometry
    from voxelray_torch.render.camera import Camera
    bb_min, bb_max = geometry.mesh_bbox(v)
    extent = float(max(bb_max - bb_min))
    center = (bb_min + bb_max) * 0.5
    cam = Camera(eye=tuple(center + np.asarray([0.9, 0.55, -0.9]) * extent),
                 center=tuple(center))
    _, _, vi, pi = cam.matrices(WIDTH, HEIGHT)
    return vi, pi, bb_min, bb_max


def inputs(tree):
    """The knot, its grid parameters and the bench camera's tiled rays on
    the card, from the tree's voxelray_torch (first on the path)."""
    import torch
    import voxelray_torch
    from voxelray_torch.io import meshes
    from voxelray_torch.ops.intersect import make_camera_rays
    from voxelray_torch.ops.kernels import _build
    from voxelray_torch.render import pipeline

    pkg = Path(voxelray_torch.__file__).resolve()
    if Path(tree).resolve() not in pkg.parents:
        raise RuntimeError(f"imported {pkg}, not the package of {tree}")
    dev = torch.device("cuda", 0)
    _build.load_library()
    v, f = meshes.torus_knot(**MESH)
    vi, pi, bb_min, bb_max = bench_camera(v)
    vs = float(max(bb_max - bb_min)) / GRID_RES
    o, d = make_camera_rays(WIDTH, HEIGHT, vi, pi, device=dev)
    o = pipeline._tile_rays(o, HEIGHT, WIDTH).contiguous()
    d = pipeline._tile_rays(d, HEIGHT, WIDTH).contiguous()
    return dev, v, f, bb_min, bb_max, vs, o, d


def voxel_scene(dev, v, f, vs):
    from voxelray_torch.models.grids import GridBool
    from voxelray_torch.models.scene import build_scene
    return build_scene(grid=GridBool.from_mesh(v, f, vs, device=dev),
                       device=dev)


def k1_kernel_alone(voxel_accum, v, f, origin, vs, dims):
    """A call of the tree's K1 launch alone: no zeroed volume, no sync."""
    import numpy as np
    import torch
    if hasattr(voxel_accum, "accum_args"):
        from voxelray_torch.ops.kernels import _build
        a, outs = voxel_accum.accum_args(v, f, origin, vs, dims)
        return lambda: (_build.launch("voxel_accum", a, v.device), outs)
    nx, ny, nz = dims
    occ = torch.zeros((nz, ny, nx), dtype=torch.uint8, device=v.device)
    counts = torch.zeros((2,), dtype=torch.int64, device=v.device)
    if hasattr(voxel_accum, "launch"):
        return lambda: voxel_accum.launch(v, f, origin, vs, dims, occ,
                                          counts)
    # a tree from before the in-kernel face check: no vertex count
    fn = voxel_accum._lib()
    org = np.asarray(origin, np.float32)
    args = (v.data_ptr(), f.data_ptr(), int(f.shape[0]), *map(float, org),
            float(np.float32(vs)), float(np.float32(vs * 0.5)), nx, ny, nz,
            occ.data_ptr(), counts.data_ptr())
    return lambda: fn(*args, torch.cuda.current_stream().cuda_stream)


def child_k1(tree):
    import torch
    from voxelray_torch.ops import geometry
    from voxelray_torch.ops.kernels import voxel_accum
    dev, v, f, bb_min, bb_max, vs, _, _ = inputs(tree)
    dims = geometry.grid_dims(bb_min, bb_max, vs)
    v_t, f_t = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
    occ, calls = voxel_accum.voxel_accum_cuda(v_t, f_t, bb_min, vs, dims)
    alone = k1_kernel_alone(voxel_accum, v_t, f_t, bb_min, vs, dims)
    ms = {"wrapper": timed(lambda: voxel_accum.voxel_accum_cuda(
              v_t, f_t, bb_min, vs, dims)),
          "kernel alone": timed(alone)}
    return {"triangles": len(f), "dims": list(dims), "ms": ms,
            "checksum": [sha(occ), calls]}


def k2_sets(tree):
    """({name: K2 arguments}, checksum of the outputs) of the tree's
    primary and shadow rays."""
    import torch
    from voxelray_torch.ops.intersect import TMAX, TMIN
    from voxelray_torch.ops.kernels import mega_trace
    from voxelray_torch.render import pipeline
    dev, v, f, _, _, vs, o, d = inputs(tree)
    scene = voxel_scene(dev, v, f, vs)
    accel = scene.accel
    n = o.shape[0]
    tmn = torch.full((n,), float(TMIN), device=dev)
    tmx = torch.full((n,), float(TMAX), device=dev)
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    t, lin, _ = mega_trace.trace_grid_mega_cuda(o, d, accel, tmn, tmx, ones)
    surf = pipeline.surface_terms(scene, o, d, t, lin)
    so, sd = surf.world_pos, surf.l_vec.contiguous()
    sdist, admit = surf.light_dist, surf.hit & surf.facing
    st, slin, _ = mega_trace.trace_grid_mega_cuda(so, sd, accel, tmn, sdist,
                                                  admit)
    adm = torch.nonzero(admit).squeeze(1)
    sets = {"primary": (o, d, accel, tmn, tmx, ones),
            "shadow, masked": (so, sd, accel, tmn, sdist, admit),
            "shadow, compacted": (so[adm].contiguous(), sd[adm].contiguous(),
                                  accel, tmn[adm].contiguous(),
                                  sdist[adm].contiguous(),
                                  admit[adm].contiguous())}
    return sets, sha(t, lin, st, slin)


def child_prep(path):
    """On this checkout: each primary ray's K2 steps, saved as
    chip_smoke.k2_step_classes' classes."""
    import torch
    sys.path[:0] = [str(REPO)]
    from chip_smoke import k2_step_classes, mega_work
    sets, _ = k2_sets(REPO)
    o, d, accel, tmn, tmx, _ = sets["primary"]
    bsteps, csteps, _, _ = mega_work(o, d, tmn, tmx, accel)
    classes, stats = k2_step_classes(bsteps, csteps)
    torch.save({k: x.cpu() for k, x in classes.items()}, path)
    print(json.dumps({"primary steps per ray": stats}), flush=True)
    return 0


def child_k2(tree, classes_path):
    import torch
    from voxelray_torch.ops.kernels import mega_trace
    sets, checksum = k2_sets(tree)
    prim = sets["primary"]
    for name, idx in torch.load(classes_path).items():
        idx = idx.to(prim[0].device)
        sets[f"primary, {name}"] = tuple(
            x if i == 2 else x[idx].contiguous() for i, x in enumerate(prim))
    ms = {name: timed(lambda: mega_trace.trace_grid_mega_cuda(*args))
          for name, args in sets.items()}
    return {"rays": {k: a[0].shape[0] for k, a in sets.items()}, "ms": ms,
            "checksum": checksum}


def child_k3(tree):
    import torch
    from voxelray_torch.ops.intersect import TMAX, TMIN
    from voxelray_torch.ops.kernels import grid_walk
    dev, v, f, _, _, vs, o, d = inputs(tree)
    accel = voxel_scene(dev, v, f, vs).accel
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
    ms = {"round 1, k 5": timed(lambda: grid_walk.walk_cuda(
              *first, **kw, k_hits=5)),
          "resume, k 8": timed(lambda: grid_walk.walk_cuda(
              *resume, **kw, k_hits=8))}
    return {"rays": [n, int(go.numel())], "ms": ms,
            "checksum": [int(x.long().sum()) for x in (hits, cell, cont,
                                                       hits2, cell2, cont2)]}


def child_k4(tree):
    import torch
    from chip_smoke import knot_model
    from voxelray_torch.models.scene import build_scene
    from voxelray_torch.ops.intersect import TMAX, TMIN
    from voxelray_torch.ops.kernels import brick_fine, grid_walk, tri_march
    from voxelray_torch.render import pipeline
    dev, v, f, _, _, vs, o, d = inputs(tree)
    n = o.shape[0]
    tmn = torch.full((n,), float(TMIN), device=dev)
    tmx = torch.full((n,), float(TMAX), device=dev)
    tscene = build_scene(models=[knot_model(v, f)], device=dev)
    ta = tscene.tri_accel
    ms, outs = {}, []
    for name, accel, k in (("512^3 round 1, k 5",
                            voxel_scene(dev, v, f, vs).accel, 5),
                           ("triangle lap 1, k 2", ta.brick, 2)):
        l2 = accel.l2 if accel.coarse.shape[0] > 4 else None
        hits, _, _ = grid_walk.walk_cuda(
            o, d, tmn, tmx, None, None, accel.coarse, l2, k_hits=k,
            bdims=accel.bdims, origin_key=accel.origin_key,
            brick_world=float(accel.voxel_size * 8))
        args = (o, d, hits, accel.fine, tmn, tmx)
        kw = dict(dims=accel.dims, bdims=accel.bdims,
                  origin_key=accel.origin_key, voxel_size=accel.voxel_size)
        outs += brick_fine.fine_cuda(*args, **kw)
        ms[name] = timed(lambda: brick_fine.fine_cuda(*args, **kw))
    prim = tri_march.tri_march_cuda(o, d, tmn, tmx, ta)
    outs += prim[:4]
    ms["tri_march primary"] = timed(
        lambda: tri_march.tri_march_cuda(o, d, tmn, tmx, ta))
    surf = pipeline.surface_terms(
        tscene, o, d, torch.full((n,), float("inf"), device=dev),
        torch.full((n,), -1, dtype=torch.int32, device=dev), tri=prim[:4])
    sel = torch.nonzero(surf.hit & surf.facing).squeeze(1)
    shadow = (surf.world_pos[sel].contiguous(), surf.l_vec[sel].contiguous(),
              torch.full((sel.numel(),), float(TMIN), device=dev),
              surf.light_dist[sel].contiguous())
    outs += tri_march.tri_march_cuda(*shadow, ta)[:4]
    ms["tri_march shadow"] = timed(
        lambda: tri_march.tri_march_cuda(*shadow, ta))
    return {"rays": n, "ms": ms, "checksum": sha(*outs)}


def child_prep_staged(path):
    """On this checkout: the TOP_STAGED primary rays with the most groups
    of the staged walk (the clock-split build of
    scripts/torch_staged_march_laps.py), saved in tile order."""
    import torch
    sys.path[:0] = [str(REPO)]
    from scripts.torch_staged_march_laps import PARTS, rows_of
    from scripts.torch_tri_march_laps import build_libs
    from voxelray_torch.ops.intersect import TMAX, TMIN
    from voxelray_torch.ops.kernels import staged_march
    dev, v, f, _, _, vs, o, d = inputs(REPO)
    accel = voxel_scene(dev, v, f, vs).accel
    n = o.shape[0]
    tmn = torch.full((n,), float(TMIN), device=dev)
    tmx = torch.full((n,), float(TMAX), device=dev)
    from voxelray_torch.ops.kernels import _build
    (lib, _), = build_libs(REPO, [["-DSTAGED_MARCH_CLOCKS"]], "staged_march")
    lanes = staged_march.launch_config(accel, lib=lib)["lanes"]

    def run(o_, d_, tmn_, tmx_):
        a, outs = staged_march.staged_args(o_, d_, accel, tmn_, tmx_, None, 5,
                                           None, lanes)
        _build.launch("staged_march", a, o_.device, lib)
        return outs
    rows, _ = rows_of(lib, run, (o, d, tmn, tmx))
    groups = rows[:, len(PARTS)]
    top = torch.sort(torch.argsort(groups, descending=True)[:TOP_STAGED])
    torch.save(top.values.cpu(), path)
    print(json.dumps({"staged groups of the longest rays":
                      groups[top.values].tolist()}), flush=True)
    return 0


def child_staged(tree, prep_path):
    import torch
    from voxelray_torch.ops.intersect import TMIN
    from voxelray_torch.ops.traverse_fast import trace_grid_fast
    from voxelray_torch.parallel.comm import make_mesh, split_zslabs
    from voxelray_torch.render import pipeline
    dev, v, f, _, _, vs, o, d = inputs(tree)
    scene = voxel_scene(dev, v, f, vs)
    accel = scene.accel
    t, lin = trace_grid_fast(o, d, accel, mega=False)
    surf = pipeline.surface_terms(scene, o, d, t, lin)
    admit = surf.hit & surf.facing
    so, sd = surf.world_pos.contiguous(), surf.l_vec.contiguous()
    dist = surf.light_dist.contiguous()
    slab = split_zslabs(scene, make_mesh(devices=[dev] * 4),
                        "fast").slabs[1]
    top = torch.load(prep_path).to(dev)
    to, td = o[top].contiguous(), d[top].contiguous()
    # each long ray beside 31 rays that miss the grid: one to a warp
    far_o, far_d = o[:1] - d[:1] * 1e6, -d[:1]
    wo = torch.cat([torch.cat([to[k:k + 1], far_o.expand(31, 3)])
                    for k in range(top.numel())]).contiguous()
    wd = torch.cat([torch.cat([td[k:k + 1], far_d.expand(31, 3)])
                    for k in range(top.numel())]).contiguous()
    calls = {
        "primary, k 5": lambda: trace_grid_fast(o, d, accel, mega=False),
        "shadow pass, admit mask, k 4": lambda: trace_grid_fast(
            so, sd, accel, t_min=float(TMIN), t_max=dist, admit=admit,
            mega=False, k_hits=4),
        "Z-slab 1, k 5": lambda: trace_grid_fast(o, d, slab, mega=False),
        f"the {top.numel()} longest, packed": lambda: trace_grid_fast(
            to, td, accel, mega=False),
        f"the {top.numel()} longest, one to a warp": lambda: trace_grid_fast(
            wo, wd, accel, mega=False)}
    outs = [x for fn in calls.values() for x in fn()]
    ms = {name: timed(fn) for name, fn in calls.items()}
    return {"rays": o.shape[0], "admitted": int(admit.sum()), "ms": ms,
            "checksum": sha(*outs)}


def child_frame(tree):
    from scripts.torch_frame_profile import profile_frame
    from voxelray_torch.render.pipeline import render_image
    dev, v, f, _, _, vs, _, _ = inputs(tree)
    vi, pi, _, _ = bench_camera(v)
    scene = voxel_scene(dev, v, f, vs)
    ms, prof, images = {}, {}, []
    for shadows in (True, False):
        def frame():
            return render_image(scene, vi, pi, width=WIDTH, height=HEIGHT,
                                backend="fast", shadows=shadows)
        images.append(frame())
        key = f"shadows {'on' if shadows else 'off'}"
        ms[key] = wall_timed(frame)
        p = profile_frame(frame, ())
        prof[key] = {"device_launches": p["device_launches"],
                     "device_busy_ms": p["device_busy_ms"]}
    return {"ms": ms, "profiled": prof, "checksum": sha(*images)}


def child(kernel, tree, prep_path):
    sys.path[:0] = [str(Path(tree).resolve())]
    from voxelray_torch.ops.kernels import _build
    row = (child_k1(tree) if kernel == "k1" else
           child_k2(tree, prep_path) if kernel == "k2" else
           child_k3(tree) if kernel == "k3" else
           child_k4(tree) if kernel == "k4" else
           child_staged(tree, prep_path) if kernel == "staged" else
           child_frame(tree))
    row = {"tree": str(tree), "kernel": kernel, **row}
    for entry in ENTRY[kernel]:
        row[f"ptxas_{entry}"] = ptxas_report(_build.build_log(), entry)
    print(json.dumps(row))
    return 0


def run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        raise SystemExit(1)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    if len(sys.argv) >= 2 and sys.argv[1] == "--prep":
        return child_prep(sys.argv[2])
    if len(sys.argv) >= 2 and sys.argv[1] == "--prep-staged":
        return child_prep_staged(sys.argv[2])
    if len(sys.argv) >= 2 and sys.argv[1] == "--child":
        return child(sys.argv[2], sys.argv[3], sys.argv[4])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(ENTRY), default="k3")
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("out", nargs="?")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_k3_ab: no CUDA device", file=sys.stderr)
        return 2
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        prep = str(Path(tmp) / "prep.pt")
        if args.kernel in ("k2", "staged"):
            rows.append(run([sys.executable, __file__,
                             "--prep" if args.kernel == "k2"
                             else "--prep-staged", prep]))
            print(json.dumps(rows[-1]), flush=True)
        for tree in (args.tree_a, args.tree_b, args.tree_b, args.tree_a):
            rows.append(run([sys.executable, __file__, "--child",
                             args.kernel, tree, prep]))
            print(json.dumps(rows[-1]), flush=True)
    sums = {json.dumps(r["checksum"]) for r in rows if "checksum" in r}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"outputs equal across trees: {len(sums) == 1}")
    print(f"card: {smi}")
    if args.out:
        out = Path(args.out).resolve()
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"kernel": args.kernel, "runs": rows,
                                   "card": smi}, indent=1))
    return 0 if len(sums) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
