"""One run of a cell: set-up, the measured window, the check, the metrics.

The harness is driven by data.  A cell is an entry of BENCHMARK.json's
`workloads`; the harness finds everything else by name:

  configs    BENCHMARK.json `configs[].file` (the scene: its kind, mesh,
             grid, frame, backend, shading, the kernels of each layer);
             the kind's module kinds/<kind>.py builds the scene for the
             program and for the reference (program.kind_of)
  traffic    traffic/<traffic>.json (the fly-through: cameras a
             revolution, the orbit, shadows, frames checked and traced)
  cells      cells/<cell>.json (the limits of the comparison)
  metrics    metrics/<metric>.py, each with read(run) -> value or None,
             for every metric BENCHMARK.json lists for the cell

A run with trace 0 measures the end-to-end metrics over a window of
`seconds`; a run with trace 1 profiles `trace_frames` cameras spread over
the orbit, `trace_rounds` times over, and reports
the per-layer metrics.  Both check the frames the seed picked.  Window
frame i is global step start + i (inputs.Flight): each frame first makes
its step's scene (a kind whose geometry changes voxelizes and builds it
there), then renders it.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import check, inputs, profile, reference
from .program import kind_of, load_kernels

__all__ = ["Spec", "load_spec", "Run", "run_cell", "read_metrics",
           "BENCH_DIR"]

BENCH_DIR = Path(__file__).resolve().parents[1]


def log(msg):
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Spec:
    """A cell and what BENCHMARK.json and the files of its names say."""

    name: str
    chips: int
    config: dict
    traffic: dict
    cell: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def load_spec(cell, bench_dir=BENCH_DIR):
    """The cell `cell` of bench_dir/../BENCHMARK.json; KeyError if none."""
    bench_dir = Path(bench_dir)
    root = bench_dir.parent
    bj = json.loads((root / "BENCHMARK.json").read_text())
    wl = {w["name"]: w for w in bj["workloads"]}
    if cell not in wl:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    w = wl[cell]
    cfg = {c["name"]: c for c in bj["configs"]}[w["config"]]
    return Spec(
        name=cell, chips=int(w["chips"]),
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads(
            (bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        cell=json.loads((bench_dir / "cells" / f"{cell}.json").read_text()),
        end_to_end=[m for m in bj["end_to_end"] if _reports(m, cell)],
        per_layer=[m for m in bj["per_layer"] if _reports(m, cell)],
        bench_dir=bench_dir)


@dataclass
class Run:
    """What a run measured; the metric readers read it."""

    spec: Spec
    geometry: object = None         # inputs.Geometry of the scene
    setup_s: float = 0.0
    build_s: float = 0.0
    frame_s: list = field(default_factory=list)
    window_s: float = 0.0
    trace: object = None            # profile.Trace of the traced window
    host_trace: object = None       # ... of a short window, host traced
    traced_frames: int = 0
    plain_s: float = 0.0            # the traced frames' seconds, untraced
    call_s: dict = field(default_factory=dict)  # ... in Program.call spans
    steps: list = field(default_factory=list)   # the traced frames' steps
    admitted: list = field(default_factory=list)
    sync_sites: list = field(default_factory=list)
    sync_frames: int = 0
    memory_peak_bytes: int = 0
    numbers: dict = field(default_factory=dict)
    failed: int = 0


def read_metrics(run, metrics):
    """{name: {"value", "unit"}} of the metrics whose reader finds
    something to read."""
    out = {}
    for m in metrics:
        path = run.spec.bench_dir / "metrics" / f"{m['name']}.py"
        mod_spec = importlib.util.spec_from_file_location(
            f"vrbench_metric_{m['name'].replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        value = mod.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _keep(bufs, img, prog):
    """Copy a checked frame's image and its step's answers."""
    bufs["image"].copy_(img)
    for name, x in prog.answers.items():
        bufs[name].copy_(x)


def _window(prog, flight, shadows, seconds, kept, device):
    """Frames back to back, each synced, until `seconds` have passed:
    (each frame's seconds, the window's seconds, the host thread's CPU
    seconds at each frame's end)."""
    times, cpu = [], []
    t_start = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        img = prog.frame_of(flight, i, shadows)
        if i in kept:
            _keep(kept[i], img, prog)
        _sync(device)
        b = time.perf_counter()
        cpu.append(time.thread_time())
        times.append(b - a)
        i += 1
        if b - t_start >= seconds:
            return times, b - t_start, cpu


def _traced(prog, flight, shadows, warm, frames, kept, device,
            host=False):
    """Profile frames back to back, each synced.  Without `host` only the
    device is traced (CUPTI's activity records; the host's own overhead
    stays small), and the window is its host-clock length; with it the
    host's ops and runtime calls are traced too, in one span.  The frames
    `warm` run first under the profiler's warm-up step, traced and thrown
    away, so that the profiler's start-up falls outside the window."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function, schedule
    on_card = device.type == "cuda"
    acts = ([ProfilerActivity.CUDA] if on_card else []) \
        + ([ProfilerActivity.CPU] if host or not on_card else [])
    steps = schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch_profile(activities=acts, schedule=steps) as prof:
        for i in warm:
            prog.frame_of(flight, i, shadows)
            _sync(device)
        prof.step()
        t0 = time.perf_counter()
        with record_function(profile.WINDOW_SPAN):
            for i in frames:
                img = prog.frame_of(flight, i, shadows)
                if i in kept:
                    _keep(kept[i], img, prog)
                _sync(device)
        window = time.perf_counter() - t0
        prof.step()
    return profile.Trace(prof, None if host else window)


def _timed(prog, flight, shadows, frames, device):
    """Seconds that `frames` take back to back, each synced, untraced."""
    t0 = time.perf_counter()
    for i in frames:
        prog.frame_of(flight, i, shadows)
        _sync(device)
    return time.perf_counter() - t0


def run_cell(spec, seed, seconds, trace, device, t_process):
    """Set up, measure, check.  Returns the Run.  t_process: the host
    clock (time.time()) when the process started."""
    cfg, tr = spec.config, spec.traffic
    kind = kind_of(cfg)
    run = Run(spec=spec)
    run.build_s = load_kernels(device)
    log(f"kernel library: {run.build_s:.3f} s")
    t0 = time.perf_counter()
    geo = run.geometry = kind.geometry(cfg)
    log(f"set-up: mesh {time.perf_counter() - t0:.3f} s")
    width, height = cfg["width"], cfg["height"]
    # a traced run's cameras are spread evenly over the orbit, so that its
    # per-layer metrics average every view whatever the start camera
    n = int(tr["trace_frames"])
    spread = [i * max(1, int(tr["cameras"]) // n) for i in range(n)]
    # ... and flown several times over, so that the traced window averages
    # over the host's swings
    traced = spread * int(tr["trace_rounds"])
    flight = inputs.Flight(tr, *geo.bbox, width, height, seed,
                           spread if trace else None)
    log(f"cell {spec.name}: {len(geo.faces)} triangles, "
        f"{len(geo.sets)} vertex set(s), grid "
        f"{geo.grid[3] if geo.grid else None}, "
        f"{width}x{height}, start camera {flight.start}, checked frames "
        f"{flight.check}")
    t0 = time.perf_counter()
    prog = kind.Program(cfg, geo, device)
    _sync(device)
    t1 = time.perf_counter()
    shadows = bool(tr["shadows"])
    # every camera once (steps 0 to n - 1: in a changing scene every
    # vertex set too, where the sets divide n or number fewer), so no
    # first-time allocation falls in the window
    warm = range(-flight.start, flight.n - flight.start)
    for i in warm:
        prog.frame_of(flight, i, shadows)
        _sync(device)
    log(f"set-up: the program's scene {t1 - t0:.3f} s "
        f"({', '.join(f'{k} {s:.3f} s' for k, s in prog.setup_s.items())}), "
        f"{len(warm)} warm-up frames {time.perf_counter() - t1:.3f} s")
    kept = {i: dict(image=torch.empty((height, width, 4),
                                      dtype=torch.float32, device=device),
                    **{k: torch.empty_like(x)
                       for k, x in prog.answers.items()})
            for i in flight.check}
    _sync(device)
    # set-up's objects out of the collector's way: a collection in the
    # window scans only what the frames make
    gc.collect()
    gc.freeze()
    run.setup_s = time.time() - t_process
    log(f"set-up: {run.setup_s:.3f} s")
    if trace:
        k, m = int(tr["sync_frames"]), int(tr["host_trace_frames"])

        def frames():
            for i in spread[:k]:
                prog.frame_of(flight, i + 1, shadows)

        if device.type == "cuda":
            run.sync_sites = profile.host_syncs(frames, device)
        run.sync_frames = k
        log(f"host syncs over {k} frames: {len(run.sync_sites)} at "
            f"{sorted(set(run.sync_sites))}")
        prog.call_s.clear()
        run.plain_s = _timed(prog, flight, shadows, traced, device)
        run.call_s = dict(prog.call_s)
        # a warm-up frame between each two traced cameras
        half = max(1, flight.n // max(1, 2 * n))
        run.trace = _traced(prog, flight, shadows,
                            [i + half for i in spread], traced, kept, device)
        run.traced_frames = len(traced)
        run.steps = [flight.step(i) for i in traced]
        run.window_s = run.trace.window_s
        # the idle gaps named by what the host did: a second, short window
        # with the host traced (its own overhead widens the gaps)
        run.host_trace = _traced(prog, flight, shadows,
                                 [i + 3 for i in spread[:m]],
                                 [i + 2 for i in spread[:m]], {}, device,
                                 host=True)
        log(f"traced {len(traced)} frames (device) in {run.window_s:.6f} "
            f"s, busy {run.trace.busy_s:.6f} s; the same frames untraced "
            f"{run.plain_s:.6f} s; {m} frames with the host in "
            f"{run.host_trace.window_s:.6f} s, busy "
            f"{run.host_trace.busy_s:.6f} s; the program's own kernels "
            f"{sorted(set(run.trace.hand_kernels()))}; host seconds in "
            f"calls {run.call_s}")
    else:
        collections = sum(g["collections"] for g in gc.get_stats())
        run.frame_s, run.window_s, cpu = _window(prog, flight, shadows,
                                                 seconds, kept, device)
        collections = sum(g["collections"] for g in gc.get_stats()) \
            - collections
        done = len(run.frame_s)
        kept = {i: img for i, img in kept.items() if i < done}
        ms = np.asarray(run.frame_s) * 1e3
        parts = [p for p in np.array_split(np.arange(done), 10) if len(p)]
        tenths = [float(np.median(ms[p])) for p in parts]
        # the host thread's share of each tenth's time spent on its CPU
        ends = np.cumsum(ms) / 1e3
        busy = [(cpu[p[-1]] - cpu[p[0]]) / max(ends[p[-1]] - ends[p[0]],
                                                1e-9) for p in parts]
        log(f"window: {done} frames in {run.window_s:.6f} s; frame ms "
            f"median {np.median(ms):.4f}, p5 {np.percentile(ms, 5):.4f}, "
            f"p95 {np.percentile(ms, 95):.4f}, max {ms.max():.4f}; "
            f"medians by tenth of the window "
            f"{', '.join(f'{x:.3f}' for x in tenths)}; the host thread "
            f"on its CPU {', '.join(f'{x:.3f}' for x in busy)} of each "
            f"tenth; {collections} garbage collections")
    if device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    gc.unfreeze()
    outputs = prog.outputs
    prog.free()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    refs = check.References(kind, cfg, geo, device)
    run.numbers, run.failed = check.judge(cfg, spec.cell, refs, flight,
                                          kept, outputs, device, log=log)
    if trace:
        # the shadow rays of each traced frame, from that frame's own
        # geometry: each camera's, every round
        run.admitted = [reference.admitted(refs(flight.step(i))[0],
                                           *flight.matrices(i), width,
                                           height, cfg["shading"], device)
                        for i in spread] * int(tr["trace_rounds"])
    log(f"check: {time.perf_counter() - t0:.3f} s")
    return run


def verdict(run):
    """(correct, {name: {"value", "limit"}}): every number within its
    limit."""
    limits = run.spec.cell["limits"]
    checks = {n: {"value": v, "limit": limits[n]}
              for n, v in run.numbers.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
