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


class Control:
    """The control in the program's place: the reference itself a precision
    below the configuration's float32 (bfloat16 voxelize, rays, walks and
    hit points), with the program's interface (vrbench/program.Program):
    a static voxel scene's voxelize as set-up's outputs, a changing one's
    as each step's answers, and the reference's frame of the step."""

    def __init__(self, kind, config, geo, device, changes):
        """changes: the kind's Program.changes."""
        import torch
        from vrbench import check
        self.refs = check.References(kind, config, geo, device,
                                     torch.bfloat16, torch.bfloat16)
        self.changes = changes
        self.config, self.device = config, device
        self.setup_s, self.call_s = {}, {}
        self.outputs, self.answers = {}, {}
        self.at = 0
        vox = self.refs(0)[1]
        if vox and not self.changes:
            self.outputs = {"occupancy": vox[0], "set_calls": vox[1]}

    def step(self, step):
        import torch
        self.at = step
        vox = self.refs(step)[1]
        if vox and self.changes:
            self.answers = {"occupancy": vox[0],
                            "set_calls": torch.tensor(vox[1])}

    def frame(self, vi, pi, shadows=True):
        from vrbench import reference
        c = self.config
        return reference.render(self.refs(self.at)[0], vi, pi, c["width"],
                                c["height"], c["shading"],
                                self.device).float()

    def frame_of(self, flight, i, shadows=True):
        self.step(flight.step(i))
        return self.frame(*flight.matrices(i), shadows=shadows)

    def free(self):
        self.refs = None


def _checked(prog, spec, geo, seed_list):
    """{seed: (flight, kept)}: each seed's checked frames and their
    answers, as a run keeps them."""
    from vrbench import inputs
    cfg, tr = spec.config, spec.traffic
    out = {}
    for s in seed_list:
        fl = inputs.Flight(tr, *geo.bbox, cfg["width"], cfg["height"], s)
        kept = {}
        for i in fl.check:
            img = prog.frame_of(fl, i, bool(tr["shadows"]))
            kept[i] = {"image": img.clone(),
                       **{k: x.clone() for k, x in prog.answers.items()}}
        out[s] = (fl, kept)
    return out


def readings(spec, seed_list, control_seeds, device, log):
    """({seed: numbers} of the program's frames, judged as a run's; the
    same of the control in the program's place)."""
    import torch
    from vrbench import check
    from vrbench.program import kind_of, load_kernels
    cfg = spec.config
    kind = kind_of(cfg)
    load_kernels(device)
    geo = kind.geometry(cfg)
    prog = kind.Program(cfg, geo, device)
    kept = _checked(prog, spec, geo, seed_list)
    outputs = prog.outputs
    prog.free()
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    refs = check.References(kind, cfg, geo, device)
    progs = {s: check.judge(cfg, spec.cell, refs, fl, k, outputs, device,
                            log=log)[0] for s, (fl, k) in kept.items()}
    del kept
    ctrl = Control(kind, cfg, geo, device, kind.Program.changes)
    ctrls = {s: check.judge(cfg, spec.cell, refs, fl, k, ctrl.outputs,
                            device, log=log)[0]
             for s, (fl, k) in _checked(ctrl, spec, geo,
                                        control_seeds).items()}
    return progs, ctrls


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
    prog, ctrl = readings(spec, seeds(args.seeds),
                          seeds(args.control_seeds), device, harness.log)
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
