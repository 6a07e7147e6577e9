#!/usr/bin/env python3
"""Where staged_march's time goes on the bench's voxel frame: groups per
ray, whether the long rays cluster in warps, and a lane's clock64 cycles
split four ways.

Builds chip_smoke.py's voxel scene (the 1,048,576-triangle torus knot
voxelized to 512^3 by K1, its brick accel) and the bench camera's
1920x1080 rays in render_image's tile order, plus that frame's shadow
pass as render_image calls it (every ray, the admit mask of hit and
facing pixels, k 4), and the primary rays through slab 1 of
render_zslab_sharded's four Z-slabs ("Z-slab 1": its build_accel_slab
accel, a fine window).  For each ray set staged_march is checked bit-equal
to the lap loop over the K3/K4 kernels (staged_march_plain) and timed
with CUDA events (two means of REPS calls):

  - groups per ray (one group: K3 brick steps collecting k occupied
    bricks and K4 over each; read from the clock-split build below), as
    a histogram, for the primary (k 5) and the shadow pass (k 4);
  - the primary rays split by their groups (>= LONG, the others) and the
    longest ray alone, each set launched alone;
  - the clustering probe: the TOP rays with the most groups, packed into
    as few warps as their tile order packs them, and one to a warp (each
    followed by 31 rays that miss the grid);
  - the clock split: csrc/staged_march.cu built alone with
    -DSTAGED_MARCH_CLOCKS (a build the package never makes) adds each
    lane's clock64 cycles on its ray to the ray's row in four parts: K3's
    brick steps (their mask reads in shared memory included), the loads
    of K4's brick words (the copies and the wait for them), K4's cell
    steps and probes, and the wait between the ray's groups (the fetch,
    and the warp's time on other lanes' paths).  Taken on the longest
    ray alone and on the rays with >= LONG groups, and summed over the
    frame;
  - ptxas's report (registers, spills) and the launch configuration
    (shared memory, blocks a multiprocessor) of every build.

With --budget, every ray set is also timed with builds of
staged_march.cu alone with each STAGED_GROUP_BUDGET value (the groups
after which a ray is deferred when rays outnumber lanes; 0: none), all
nvcc's at once.  Another tree's kernel is timed against this one by
scripts/torch_k3_ab.py --kernel staged.

Prints one JSON line per measurement and the card's name and power
limit.

    python3 scripts/torch_staged_march_laps.py [--budget 0,2] [OUT.json]

Needs one CUDA device and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
WIDTH, HEIGHT = 1920, 1080
REPS = 20
LONG = 4
TOP = 40
PARTS = ("k3", "loads", "k4", "wait")


def rows_of(lib, run, rays):
    """The clock-split build's per-ray rows of one launch on `rays`:
    (n, 5) int64 on the card (the four parts' cycles, then groups)."""
    import torch
    n = rays[0].shape[0]
    rows = torch.zeros((n, len(PARTS) + 1), dtype=torch.int64,
                       device=rays[0].device)
    fn = lib.staged_march_clocks
    fn.argtypes = [ctypes.c_void_p]
    if fn(rows.data_ptr()) != 0:
        raise RuntimeError("staged_march_clocks failed")
    out = run(*rays)
    torch.cuda.synchronize()
    return rows, out


def split(rows, sel=None):
    """The clock split summed over the rays `sel` (a bool mask, or all)."""
    r = rows if sel is None else rows[sel]
    cyc = [int(r[:, k].sum()) for k in range(len(PARTS))]
    groups = int(r[:, len(PARTS)].sum())
    total = max(sum(cyc), 1)
    return {"rays": int(r.shape[0]), "ray_groups": groups,
            "cycles": dict(zip(PARTS, cyc)),
            "share": {p: round(c / total, 4) for p, c in zip(PARTS, cyc)},
            "cycles_per_group": {p: round(c / max(groups, 1), 1)
                                 for p, c in zip(PARTS, cyc)}}


def spread(rays, far):
    """The rays of `rays` one to a warp: each followed by 31 copies of the
    ray `far` (one that misses the grid and ends in its first group)."""
    import torch
    out = []
    for x, f in zip(rays, far):
        pad = f.expand(31, *f.shape[1:])
        out.append(torch.cat([torch.cat([x[k:k + 1], pad])
                              for k in range(x.shape[0])]).contiguous())
    return tuple(out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--budget", default="",
                    help="comma-separated STAGED_GROUP_BUDGET values: a "
                    "build of staged_march.cu with each, timed")
    ap.add_argument("out", nargs="?")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_staged_march_laps: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import GRID_RES, MESH, bench_camera, smi_line
    from scripts.torch_tri_march_laps import build_libs, ptxas
    from voxelray_torch.io import meshes
    from voxelray_torch.models.grids import GridBool
    from voxelray_torch.models.scene import build_scene
    from voxelray_torch.ops import geometry
    from voxelray_torch.ops.intersect import TMAX, TMIN, make_camera_rays
    from voxelray_torch.ops.kernels import _build, staged_march
    from voxelray_torch.parallel.comm import make_mesh, split_zslabs
    from voxelray_torch.render import pipeline

    dev = torch.device("cuda", 0)
    variants = {"clock split": ["-DSTAGED_MARCH_CLOCKS"]}
    variants.update({f"budget {int(k)}": [f"-DSTAGED_GROUP_BUDGET={int(k)}"]
                     for k in args.budget.split(",") if k})
    libs = dict(zip(variants, build_libs(REPO, variants.values(),
                                         "staged_march")))
    clock_lib = libs.pop("clock split")

    v, f = meshes.torus_knot(**MESH)
    bb_min, bb_max = geometry.mesh_bbox(v)
    vs = float(max(bb_max - bb_min)) / GRID_RES
    cam, _ = bench_camera(bb_min, bb_max)
    _, _, vi, pi = cam.matrices(WIDTH, HEIGHT)
    scene = build_scene(grid=GridBool.from_mesh(v, f, vs, device=dev),
                        device=dev)
    accel = scene.accel
    o, d = make_camera_rays(WIDTH, HEIGHT, vi, pi, device=dev)
    o = pipeline._tile_rays(o, HEIGHT, WIDTH).contiguous()
    d = pipeline._tile_rays(d, HEIGHT, WIDTH).contiguous()
    n = o.shape[0]
    tmn = torch.full((n,), float(TMIN), device=dev)
    tmx = torch.full((n,), float(TMAX), device=dev)
    prim = staged_march.staged_march_cuda(o, d, accel, tmn, tmx, None, 5,
                                          None)
    surf = pipeline.surface_terms(scene, o, d, prim[0], prim[1])
    # (o, d, t_min, t_max, admit, k) of each set
    sets = {"primary": (o, d, tmn, tmx, None, 5),
            "shadow": (surf.world_pos.contiguous(), surf.l_vec.contiguous(),
                       tmn, surf.light_dist.contiguous(),
                       (surf.hit & surf.facing).contiguous(), 4)}

    # the accel of each set: the scene's, or for "Z-slab 1" slab 1 of
    # render_zslab_sharded's four (its fine table a window)
    slab = split_zslabs(scene, make_mesh(devices=[dev] * 4),
                        "fast").slabs[1]
    sets["Z-slab 1"] = sets["primary"]
    accels = {"Z-slab 1": slab}

    def kernel(lib=None, acc=accel):
        """The trace of `lib`, a build of staged_march.cu alone (None: the
        package's), the wrapper's argument block through its binder."""
        def run(o_, d_, tmn_, tmx_, admit, k):
            lanes = staged_march.launch_config(acc, lib=lib)["lanes"]
            a, outs = staged_march.staged_args(o_, d_, acc, tmn_, tmx_,
                                               admit, k, None, lanes)
            _build.launch("staged_march", a, o_.device, lib)
            return outs
        return run

    def same(got, want):
        return (torch.equal(got[1], want[1]) and int(got[2]) == 0
                and torch.equal(got[0].view(torch.int32),
                                want[0].view(torch.int32)))

    smi = smi_line()
    out_rows = []

    def emit(row):
        row["card"] = smi
        print(json.dumps(row), flush=True)
        out_rows.append(row)

    # groups per ray and the clock split over each whole pass
    groups = {}
    for name in ("primary", "shadow"):
        rays = sets[name]
        want = staged_march.staged_march_plain(
            rays[0], rays[1], accel, rays[2], rays[3], rays[4], rays[5],
            None)
        if not same(kernel()(*rays), want):
            print(f"{name}: staged_march differs from the lap loop",
                  file=sys.stderr)
            return 1
        rows, got = rows_of(clock_lib[0], kernel(clock_lib[0]), rays)
        if not same(got, want):
            print(f"{name}: the clock-split build differs from the lap "
                  "loop", file=sys.stderr)
            return 1
        g = rows[:, len(PARTS)]
        groups[name] = g
        traced = g > 0
        hist = torch.bincount(g[traced]).tolist()
        emit({"rays": name, "n": rays[0].shape[0],
              "traced": int(traced.sum()),
              "groups_per_ray": {k: c for k, c in enumerate(hist) if c},
              "max_groups": len(hist) - 1,
              "clock_split": split(rows, traced)})
    g = groups["primary"]
    top = torch.sort(torch.argsort(g, descending=True)[:TOP]).values
    far = (o[:1] - d[:1] * 1e6, -d[:1], tmn[:1], tmx[:1])

    def subset(idx):
        return (o[idx].contiguous(), d[idx].contiguous(),
                tmn[idx].contiguous(), tmx[idx].contiguous(), None, 5)

    sets[f"primary, rays with >= {LONG} groups"] = subset(
        torch.nonzero(g >= LONG).squeeze(1))
    sets[f"primary, rays with < {LONG} groups"] = subset(
        torch.nonzero(g < LONG).squeeze(1))
    sets["primary, the longest ray"] = subset(torch.argmax(g)[None])
    sets[f"primary, the {TOP} longest, packed"] = subset(top)
    sets[f"primary, the {TOP} longest, one to a warp"] = (
        *spread(subset(top)[:4], far), None, 5)
    emit({"the longest rays": f"top {TOP} by groups",
          "groups": g[top].tolist(), "index": top.tolist(),
          "warps_packed": len({int(i) // 32 for i in top})})

    for name, rays in sets.items():
        acc = accels.get(name, accel)
        runs = [("kernel", kernel(acc=acc))] + [
            (label, kernel(lib, acc)) for label, (lib, _) in libs.items()]
        want = staged_march.staged_march_plain(
            rays[0], rays[1], acc, rays[2], rays[3], rays[4], rays[5], None)
        row = {"rays": name, "n": rays[0].shape[0]}
        for label, run in runs:
            if not same(run(*rays), want):
                print(f"{name}: the {label} build differs from the lap "
                      "loop", file=sys.stderr)
                return 1
            row[f"ms {label}"] = [
                cuda_ms_of(lambda: run(*rays)) for _ in range(2)]
        if name in (f"primary, rays with >= {LONG} groups",
                    "primary, the longest ray"):
            rows, _ = rows_of(clock_lib[0], kernel(clock_lib[0]), rays)
            row["clock_split"] = split(rows)
            row["ms clock split"] = cuda_ms_of(
                lambda: kernel(clock_lib[0])(*rays))
        emit(row)
    builds = {"package": {"ptxas": ptxas(_build.build_log(),
                                         "staged_march_kernel"),
                          "config": staged_march.launch_config(accel)},
              "clock split": {"ptxas": ptxas(clock_lib[1],
                                             "staged_march_kernel")}}
    for label, (lib, log) in libs.items():
        builds[label] = {"ptxas": ptxas(log, "staged_march_kernel")}
        if hasattr(lib, "staged_march_config"):
            builds[label]["config"] = staged_march.launch_config(accel,
                                                                 lib=lib)
    emit({"builds": builds})
    if args.out:
        out = Path(args.out).resolve()
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(out_rows, indent=1))
    print(f"card: {smi}")
    return 0


def cuda_ms_of(fn):
    """Mean device ms of REPS calls of fn (after one warm-up)."""
    from chip_smoke import cuda_ms
    return cuda_ms(fn, REPS)


if __name__ == "__main__":
    sys.exit(main())
