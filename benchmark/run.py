#!/usr/bin/env python3
"""Run one cell of the benchmark of voxelray_torch once, on the CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

With --trace 0 the cell's end-to-end metrics are measured over a window of
--seconds; with --trace 1 a profiled window gives its per-layer metrics.
Both check the frames the seed picked against the plain reference
(vrbench/reference.py) and print, as the last line of standard output, one
JSON object: correct, attempted, failed, metrics, device (and with
--trace 1 the breakdown), then every number compared beside its limit
under "checks"; the same numbers end standard error.

Exits non-zero with no result line without a CUDA card (or with fewer
than the cell asks for), and when the process has loaded jax, jaxlib,
flax or voxelray_tpu.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "voxelray_tpu")


def process_start():
    """The host clock when this process started (from /proc), or the
    first line of this file where /proc says nothing."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        started = time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
        return min(started, T_START)
    except (OSError, ValueError, IndexError):
        return T_START


def forbidden_modules():
    """Loaded modules whose top-level name is a JAX one or the JAX
    package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _smi():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_process = process_start()
    stamps = [("interpreter", T_START)]

    import torch
    stamps.append(("import torch", time.time()))
    sys.path.insert(0, str(BENCH_DIR))
    sys.path.insert(1, str(BENCH_DIR.parent))
    from vrbench import harness
    stamps.append(("the harness", time.time()))

    spec = harness.load_spec(args.workload, BENCH_DIR)
    if not torch.cuda.is_available():
        print("run.py: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec.chips:
        print(f"run.py: {spec.chips} CUDA devices needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    stamps.append(("the CUDA context", time.time()))
    t = t_process
    for what, at in stamps:
        harness.log(f"set-up: {what} {at - t:.3f} s")
        t = at
    run = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                           device, t_process)
    metrics = harness.read_metrics(
        run, spec.per_layer if args.trace else spec.end_to_end)
    correct, checks = harness.verdict(run)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": correct,
           "attempted": run.traced_frames if args.trace
           else len(run.frame_s),
           "failed": run.failed, "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.host_trace.idle_gaps()}
    out["checks"] = checks
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the process loaded {bad}", file=sys.stderr)
        return 3
    print(f"card: {_smi()}; kernel library {run.build_s:.3f} s; "
          f"set-up {run.setup_s:.3f} s", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
