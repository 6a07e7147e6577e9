#!/usr/bin/env python3
"""The readings that the limits of a cell's comparison are set from.

    python3 benchmark/control.py --workload <cell> --seeds 12 \\
        --control-seeds 3 --out chiprun_out/control_<cell>.json

In one process, at the cell's own size: the program's frames for the
checked frames of each of the first `--seeds` seeds, judged as a run
judges them (the lower readings); then the control, the reference itself
computed a precision below the configuration's float32 (bfloat16: its
voxelize, its walks and its shading) put in the program's place, for
`--control-seeds` seeds (the upper readings).  The benchmark's runs do
not run this.  Prints one JSON line a seed and side, and writes them all
to --out.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent

SEED0 = 3_000_000_019       # seeds SEED0 + 7919 k: none a run has used


def seeds(n):
    return [SEED0 + 7919 * k for k in range(n)]


def program_readings(spec, seed_list, device, log):
    """{seed: numbers} of the program's frames, judged as a run's."""
    import torch
    from vrbench import check, inputs
    from vrbench.program import Program, load_kernels
    cfg, tr = spec.config, spec.traffic
    load_kernels(device)
    v, f = inputs.mesh_of(cfg)
    grid = (inputs.grid_of(v, cfg["grid_res"]) if cfg["kind"] == "voxel"
            else None)
    prog = Program(cfg, v, f, grid, device)
    kept = {}
    for s in seed_list:
        fl = inputs.Flight(tr, *inputs.bbox(v), cfg["width"], cfg["height"],
                           s)
        kept[s] = (fl, {i: prog.frame(*fl.matrices(i),
                                      shadows=bool(tr["shadows"])).clone()
                        for i in fl.check})
    outputs = prog.outputs
    prog.free()
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    scene, vox = check.reference_scene(cfg, v, f, grid, device)
    out = {}
    for s in seed_list:
        fl, frames = kept[s]
        out[s], _ = check.judge(cfg, spec.cell, scene, vox, fl, frames,
                                outputs, device, log=log)
    return out, (v, f, grid, scene, vox)


def control_readings(spec, seed_list, made, device, log):
    """{seed: numbers} of the control in the program's place."""
    import torch
    from vrbench import check, inputs, reference
    cfg, tr = spec.config, spec.traffic
    v, f, grid, scene, vox = made
    low, low_vox = check.reference_scene(cfg, v, f, grid, device,
                                         torch.bfloat16, torch.bfloat16)
    outputs = ({"occupancy": low_vox[0], "set_calls": low_vox[1]}
               if low_vox else {})
    out = {}
    for s in seed_list:
        fl = inputs.Flight(tr, *inputs.bbox(v), cfg["width"], cfg["height"],
                           s)
        frames = {i: reference.render(low, *fl.matrices(i), cfg["width"],
                                      cfg["height"], cfg["shading"],
                                      device).float()
                  for i in fl.check}
        out[s], _ = check.judge(cfg, spec.cell, scene, vox, fl, frames,
                                outputs, device, log=log)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch
    sys.path.insert(0, str(BENCH_DIR))
    sys.path.insert(1, str(BENCH_DIR.parent))
    from vrbench import harness
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = harness.load_spec(args.workload, BENCH_DIR)
    t0 = time.perf_counter()
    prog, made = program_readings(spec, seeds(args.seeds), device,
                                  harness.log)
    ctrl = control_readings(spec, seeds(args.control_seeds), made, device,
                            harness.log)
    rows = ([{"cell": spec.name, "side": "program", "seed": s, **n}
             for s, n in prog.items()]
            + [{"cell": spec.name, "side": "control", "seed": s, **n}
               for s, n in ctrl.items()])
    for r in rows:
        print(json.dumps(r), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"card": torch.cuda.get_device_name(device), "rows": rows,
         "seconds": time.perf_counter() - t0}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
