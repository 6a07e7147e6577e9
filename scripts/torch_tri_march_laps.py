#!/usr/bin/env python3
"""Where tri_march's time goes on the bench's triangle frame: laps per ray,
and inside a lap the walk, the row's loads and the tests.

Builds chip_smoke.py's triangle scene (the 1,048,576-triangle torus knot
as one triangle model, res-256 tri grid) and the bench camera's 1920x1080
rays in render_image's tile order, plus that frame's shadow rays (hit and
facing the light).  For each ray set: how many rays are still marching
in each lap (from the lap loop over the K3/K4 kernels, which gives the
kernel's outputs bit for bit), and tri_march checked equal to it and
timed with CUDA events.  The primary rays are also timed split by their
lap count (the rays with at least LONG laps, the others, and the longest
ray alone): a kernel whose time follows its longest ray is bound by that
ray's chain of dependent steps, not by the work of all rays.

The lap split: csrc/tri_march.cu built alone with -DTRI_MARCH_LAP_CLOCKS
(a build the package never makes) sums each lane's clock64 cycles in
three parts of a lap: the staged walk (with the ray fetch between laps),
the row's loads (their issue and the wait for them) and the
Moller-Trumbore tests.  A lane's cycles include the time its warp spends
on other lanes' paths, so the split is exact only for a ray alone; it is
taken on the long rays and on the longest ray alone.

The long rays are also timed with the L2 cache flushed before each call,
and the rays with >= 64 laps both as they come (packed into a warp or
two) and one to a warp (each beside 31 rays that miss the grid).  With
--share and --budget, every ray set is also timed with builds of
tri_march.cu alone that set the ray schedule otherwise: each
TRI_SHARE_LANES (the lanes holding a ray below which a warp shares its
rows) or TRI_LAP_BUDGET (the laps after which a ray is deferred; 0:
none); the kernel's defaults are chosen from these.  ptxas's report and
the blocks a multiprocessor holds come with each build.

With --idle, instead: the longest stretch in which a warp held no ray
(the wait of an idle warp for the rays that running warps hold), in
clock64 cycles and in ns, from a build of tri_march.cu alone with
-DTRI_MARCH_IDLE_CLOCKS, on the frame's primary and shadow rays and on
the primary rays through a triangle accel whose rows are capped at
kRowChunk + 5 triangles (the host tests' "capped" scene at full scale:
its overflowing cells keep their first triangles).

Prints one JSON line per measurement and the card's name and power
limit.

    python3 scripts/torch_tri_march_laps.py [--tree TREE] [--share 0,4]
        [--budget 0,16] [--idle] [OUT.json]

TREE (default: this checkout) is the source tree whose voxelray_torch
and chip_smoke.py are imported, e.g. another commit unpacked with `git
archive` into a directory that .gitignore lists; a tree whose
tri_march.cu has no TRI_MARCH_LAP_CLOCKS gets no lap split, and one with
no TRI_SHARE_LANES no --share or --budget builds.
Needs one CUDA device and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WIDTH, HEIGHT = 1920, 1080
REPS = 20
LONG = 16
PARTS = ("walk", "loads", "tests")


def build_libs(tree, variants, name="tri_march"):
    """csrc/<name>.cu of `tree` built alone once for each list of -D
    flags in `variants`, all nvcc's at once, each into
    voxelray_torch/_build/laps-<hash>/: [(CDLL, nvcc's log)]."""
    from voxelray_torch.ops.kernels import _build
    src = Path(tree) / "voxelray_torch" / "csrc" / f"{name}.cu"
    jobs = []
    for defines in variants:
        flags = [*_build.NVCC_FLAGS, *defines]
        h = hashlib.sha256(" ".join(flags + [name]).encode())
        for f in sorted(src.parent.glob("*.cu*")):
            h.update(f.read_bytes())
        out = _build.BUILD_DIR / f"laps-{h.hexdigest()[:16]}"
        out.mkdir(parents=True, exist_ok=True)
        lib = out / f"lib{name}.so"
        jobs.append((lib, subprocess.Popen(
            [_build.find_nvcc(), *flags, "-I", str(src.parent), "-shared",
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    built = []
    for lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib}:\n{log[-4000:]}")
        built.append((ctypes.CDLL(str(lib)), log))
    return built


def ptxas(log, kernel="tri_march_kernel"):
    """ptxas's lines (registers, spills, shared memory) for the entry
    function whose name holds `kernel`."""
    out, inside = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            inside = kernel in ln
        elif inside and ("registers" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def config(lib, ta):
    """tri_march.launch_config of a build's launch on `ta`, or None for a
    build without tri_march_config."""
    from voxelray_torch.ops.kernels import tri_march
    if not hasattr(lib, "tri_march_config"):
        return None
    if not hasattr(tri_march, "march_args"):      # a tree from before it
        return tri_march.launch_config(ta, lib)
    return tri_march.launch_config(ta, lib=lib)


def launcher(lib, ta):
    """A function (o, d, t_min, t_max) -> tri_march's outputs that
    launches the kernel of `lib`, a build of tri_march.cu alone: the
    wrapper's argument block through the package's binder (a tree from
    before the argument blocks: its wrapper's `lib`)."""
    from voxelray_torch.ops.kernels import _build, tri_march
    if not hasattr(tri_march, "march_args"):
        return lambda o, d, tmn, tmx: tri_march.tri_march_cuda(
            o, d, tmn, tmx, ta, lib=lib)
    lanes = tri_march.launch_config(ta, lib=lib)["lanes"]

    def run(o, d, tmn, tmx):
        a, outs = tri_march.march_args(o, d, tmn, tmx, ta, None, lanes)
        _build.launch("tri_march", a, o.device, lib)
        return outs
    return run


def same(got, want):
    import torch
    hit = want[1] >= 0
    return (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[2][hit], want[2][hit])
            and torch.equal(got[3][hit], want[3][hit]) and int(got[4]) == 0)


def lap_split(lib, run, rays):
    """(cycles of each part summed over lanes, ray-laps) of one launch."""
    import torch
    clocks = (ctypes.c_ulonglong * 4)()
    lib.tri_march_lap_clocks.argtypes = [ctypes.c_void_p]
    run(*rays)
    torch.cuda.synchronize()
    lib.tri_march_lap_clocks(clocks)
    run(*rays)
    torch.cuda.synchronize()
    if lib.tri_march_lap_clocks(clocks) != 0:
        raise RuntimeError("tri_march_lap_clocks failed")
    cyc = [int(c) for c in clocks]
    total = sum(cyc[:3])
    return {"cycles": dict(zip(PARTS, cyc[:3])), "ray_laps": cyc[3],
            "share": {p: round(c / total, 4) for p, c in zip(PARTS, cyc)},
            "cycles_per_lap": {p: round(c / max(cyc[3], 1), 1)
                               for p, c in zip(PARTS, cyc)}}


def cold_ms(fn, reps):
    """Mean device ms of fn() with the L2 cache flushed before each call
    (a 128 MB write between the calls, outside the timed span)."""
    import torch
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    total = 0.0
    fn()
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def spread(rays, far):
    """The rays of `rays` one to a warp: each followed by 31 copies of
    `far` (a ray that misses the grid and ends in its first lap), so
    that after one lap each warp holds one of them alone."""
    import torch
    out = []
    for x, f in zip(rays, far):
        pad = f.expand(31, *f.shape[1:]) if x.dim() > 1 else f.expand(31)
        out.append(torch.cat([torch.cat([x[k:k + 1], pad])
                              for k in range(x.shape[0])]).contiguous())
    return tuple(out)


def idle_waits(lib, sets, smi):
    """The idle-wait build's longest idle stretch of a warp on each ray set
    (the last also through the capped accel), checked equal to the lap
    loop: [row]."""
    import torch
    from voxelray_torch.ops.kernels import tri_march
    fn = lib.tri_march_idle_clocks
    fn.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_ulonglong * 2)()
    rows = []
    for name, accel, rays in sets:
        want = tri_march.tri_march_plain(*rays, accel)
        fn(out)
        got = launcher(lib, accel)(*rays)
        torch.cuda.synchronize()
        if fn(out) != 0:
            raise RuntimeError("tri_march_idle_clocks failed")
        if not same(got, want):
            raise RuntimeError(f"{name}: the idle-wait build differs from "
                               "the lap loop")
        rows.append({"rays": name, "n": rays[0].shape[0],
                     "l_width": accel.l_width,
                     "overflow_cells": accel.overflow_cells,
                     "longest_idle_cycles": int(out[0]),
                     "longest_idle_ms": int(out[1]) / 1e6, "card": smi})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--share", default="",
                    help="comma-separated TRI_SHARE_LANES values: a build "
                    "of tri_march.cu with each, timed")
    ap.add_argument("--budget", default="",
                    help="comma-separated TRI_LAP_BUDGET values: a build "
                    "of tri_march.cu with each, timed")
    ap.add_argument("--idle", action="store_true",
                    help="measure the longest idle wait of a warp instead")
    ap.add_argument("out", nargs="?")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_tri_march_laps: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from chip_smoke import MESH, bench_camera, cuda_ms, knot_model, smi_line
    from voxelray_torch.io import meshes
    from voxelray_torch.models.scene import build_scene
    from voxelray_torch.ops import geometry
    from voxelray_torch.ops.intersect import TMAX, TMIN, make_camera_rays
    from voxelray_torch.ops.kernels import _build, tri_march
    from voxelray_torch.render import pipeline

    dev = torch.device("cuda", 0)
    src = (tree / "voxelray_torch/csrc/tri_march.cu").read_text()
    variants = {}
    if args.idle:
        variants["idle"] = ["-DTRI_MARCH_IDLE_CLOCKS"]
    elif "TRI_MARCH_LAP_CLOCKS" in src:
        variants["lap split"] = ["-DTRI_MARCH_LAP_CLOCKS"]
    if "TRI_SHARE_LANES" in src:
        variants.update({f"share {k}": [f"-DTRI_SHARE_LANES={int(k)}"]
                         for k in args.share.split(",") if k})
        variants.update({f"budget {k}": [f"-DTRI_LAP_BUDGET={int(k)}"]
                         for k in args.budget.split(",") if k})
    libs = dict(zip(variants, build_libs(tree, variants.values())))
    clock_lib = libs.get("lap split")

    v, f = meshes.torus_knot(**MESH)
    bb_min, bb_max = geometry.mesh_bbox(v)
    cam, _ = bench_camera(bb_min, bb_max)
    _, _, vi, pi = cam.matrices(WIDTH, HEIGHT)
    scene = build_scene(models=[knot_model(v, f)], device=dev)
    ta = scene.tri_accel
    o, d = make_camera_rays(WIDTH, HEIGHT, vi, pi, device=dev)
    o = pipeline._tile_rays(o, HEIGHT, WIDTH).contiguous()
    d = pipeline._tile_rays(d, HEIGHT, WIDTH).contiguous()
    n = o.shape[0]
    tmn = torch.full((n,), float(TMIN), device=dev)
    tmx = torch.full((n,), float(TMAX), device=dev)
    prim = tri_march.tri_march_cuda(o, d, tmn, tmx, ta)
    surf = pipeline.surface_terms(
        scene, o, d, torch.full((n,), float("inf"), device=dev),
        torch.full((n,), -1, dtype=torch.int32, device=dev), tri=prim[:4])
    sel = torch.nonzero(surf.hit & surf.facing).squeeze(1)
    sets = {"primary": (o, d, tmn, tmx),
            "shadow": (surf.world_pos[sel].contiguous(),
                       surf.l_vec[sel].contiguous(),
                       torch.full((sel.numel(),), float(TMIN), device=dev),
                       surf.light_dist[sel].contiguous())}
    if args.idle:
        from voxelray_torch.ops.tri_accel import build_tri_accel
        chunk = int(re.search(r"constexpr int kRowChunk = (\d+);",
                              src).group(1))
        capped = build_tri_accel(
            *(x.cpu().numpy() for x in (scene.tri_v0, scene.tri_v1,
                                        scene.tri_v2)),
            res=256, max_l_width=chunk + 5, device=dev)  # build_scene's res
        smi = smi_line()
        rows = idle_waits(libs["idle"][0], [("primary", ta, sets["primary"]),
                           ("shadow", ta, sets["shadow"]),
                           ("primary, rows capped", capped,
                            sets["primary"])], smi)
        if args.out:
            out = Path(args.out).resolve()
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(rows, indent=1))
        print(f"card: {smi}")
        return 0
    work = {}
    tri_march.tri_march_plain(o, d, tmn, tmx, ta, work=work)
    laps = work["ray_laps"]
    long_name = f"primary, rays with >= {LONG} laps"
    longest = "primary, the longest ray"
    for name, idx in (
            (long_name, torch.nonzero(laps >= LONG).squeeze(1)),
            (f"primary, rays with < {LONG} laps",
             torch.nonzero(laps < LONG).squeeze(1)),
            (longest, torch.argmax(laps)[None])):
        sets[name] = (o[idx], d[idx], tmn[idx], tmx[idx])
    # the rays with >= 64 laps packed into warps as they come, and one to
    # a warp beside rays that miss the grid: whether a warp's other long
    # rays slow a long ray's laps
    idx = torch.nonzero(laps >= 64).squeeze(1)
    sets["primary, rays with >= 64 laps"] = (o[idx], d[idx], tmn[idx],
                                             tmx[idx])
    far = (o[:1] - d[:1] * 1e6, -d[:1], tmn[:1], tmx[:1])
    sets["primary, rays with >= 64 laps, one to a warp"] = spread(
        sets["primary, rays with >= 64 laps"], far)
    smi = smi_line()
    print(f"tree {tree}: tri accel dims {ta.dims}, l_width {ta.l_width}, "
          f"{ta.cell_tris.shape[0]} rows, {ta.tri9.shape[0] - 1} triangles",
          flush=True)
    rows = []
    runs = [(label, launcher(lib, ta)) for label, (lib, _) in libs.items()
            if label != "lap split"]
    for name, rays in sets.items():
        work = {}
        want = tri_march.tri_march_plain(*rays, ta, work=work)
        active = work["active"]
        if not same(tri_march.tri_march_cuda(*rays, ta), want):
            print(f"{name}: tri_march differs from the lap loop",
                  file=sys.stderr)
            return 1
        row = {"rays": name, "n": rays[0].shape[0], "ray_laps": work["laps"],
               "max_laps": len(active),
               "rays_with_laps_at_least": {k: active[k - 1] for k in
                                           (1, 2, 4, 8, 16, 32, 64, 100)
                                           if k <= len(active)},
               "ms": [cuda_ms(lambda: tri_march.tri_march_cuda(*rays, ta),
                              REPS) for _ in range(2)],
               "card": smi}
        if rays[0].shape[0] < 4096:
            row["ms, L2 flushed"] = cold_ms(
                lambda: tri_march.tri_march_cuda(*rays, ta), REPS)
        for label, run in runs:
            if not same(run(*rays), want):
                print(f"{name}: the {label} build differs from the lap "
                      "loop", file=sys.stderr)
                return 1
            row[f"ms {label}"] = [cuda_ms(lambda: run(*rays), REPS)
                                  for _ in range(2)]
        if clock_lib is not None and name in (long_name, longest):
            run = launcher(clock_lib[0], ta)
            if not same(run(*rays), want):
                print(f"{name}: the lap-split build differs from the lap "
                      "loop", file=sys.stderr)
                return 1
            row["lap_split"] = lap_split(clock_lib[0], run, rays)
            row["lap_split"]["ms"] = cuda_ms(lambda: run(*rays), REPS)
        print(json.dumps(row), flush=True)
        rows.append(row)
    builds = {"package": {"ptxas": ptxas(_build.build_log()),
                          "config": config(_build.load_library(), ta)}}
    for label, (lib, log) in libs.items():
        builds[label] = {"ptxas": ptxas(log), "config": config(lib, ta)}
    print(json.dumps({"ptxas": builds}), flush=True)
    rows.append({"ptxas": builds})
    if args.out:
        out = Path(args.out).resolve()
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rows, indent=1))
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
