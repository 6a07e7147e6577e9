#!/usr/bin/env python3
"""Where tri_march's time goes on the bench's triangle frame: laps per ray.

Builds chip_smoke.py's triangle scene (the 1,048,576-triangle torus knot
as one triangle model, res-256 tri grid) and the bench camera's 1920x1080
rays in render_image's tile order, plus that frame's shadow rays (hit and
facing the light).  For each ray set: how many rays are still marching
in each lap (from the lap loop over the K3/K4 kernels, which gives the
kernel's outputs bit for bit), and tri_march checked equal to it and
timed with CUDA events.  The primary rays are also timed split by their
lap count (the rays with at least LONG laps, the others, and the longest
ray alone): a kernel whose time follows its longest ray is bound by that
ray's chain of dependent steps, not by the work of all rays.  Prints one
JSON line per ray set and the card's name and power limit.

    python3 scripts/torch_tri_march_laps.py [OUT.json]

Needs one CUDA device and nvcc; imports no JAX.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WIDTH, HEIGHT = 1920, 1080
REPS = 20
LONG = 16


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_tri_march_laps: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from chip_smoke import MESH, bench_camera, cuda_ms, knot_model, smi_line
    from voxelray_torch.io import meshes
    from voxelray_torch.models.scene import build_scene
    from voxelray_torch.ops import geometry
    from voxelray_torch.ops.intersect import TMAX, TMIN, make_camera_rays
    from voxelray_torch.ops.kernels import tri_march
    from voxelray_torch.render import pipeline

    dev = torch.device("cuda", 0)
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
    work = {}
    tri_march.tri_march_plain(o, d, tmn, tmx, ta, work=work)
    laps = work["ray_laps"]
    for name, idx in (
            (f"primary, rays with >= {LONG} laps",
             torch.nonzero(laps >= LONG).squeeze(1)),
            (f"primary, rays with < {LONG} laps",
             torch.nonzero(laps < LONG).squeeze(1)),
            ("primary, the longest ray", torch.argmax(laps)[None])):
        sets[name] = (o[idx], d[idx], tmn[idx], tmx[idx])
    smi = smi_line()
    rows = []
    for name, rays in sets.items():
        work = {}
        want = tri_march.tri_march_plain(*rays, ta, work=work)
        active = work["active"]
        got = tri_march.tri_march_cuda(*rays, ta)
        hit = want[1] >= 0
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and torch.equal(got[2][hit], want[2][hit])
                and torch.equal(got[3][hit], want[3][hit])
                and int(got[4]) == 0):
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
        print(json.dumps(row), flush=True)
        rows.append(row)
    if len(sys.argv) > 1:
        out = Path(sys.argv[1]).resolve()
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rows, indent=1))
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
