"""Benchmark harness — the Benchmaker equivalent (hello_vulkan.h:172-241).

Counterpart of voxelray_tpu/utils/timing.py.  Times N runs of grid build
/ AABB extraction and reports averages plus memory bytes; adds what the
reference displays but never records: render throughput in Mrays/s.
Every run ends with a synchronize of the CUDA devices its results live
on, so wall-clock numbers cover the device work, not its enqueue.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

__all__ = ["Benchmarker", "BenchResult", "time_fn"]


def _cuda_devices(x, found, seen):
    """Add to `found` the CUDA devices of every tensor reachable from x
    through sequences, dicts and object attributes (grids, scenes)."""
    if id(x) in seen:
        return
    seen.add(id(x))
    if torch.is_tensor(x):
        if x.is_cuda:
            found.add(x.device)
        return
    if isinstance(x, dict):
        x = list(x.values())
    elif hasattr(x, "__dict__") and not isinstance(x, type):
        x = list(vars(x).values())
    if isinstance(x, (list, tuple)):
        for y in x:
            _cuda_devices(y, found, seen)


def _block(result):
    """Wait for the devices that hold result's tensors (none on the
    CPU)."""
    found = set()
    _cuda_devices(result, found, set())
    for dev in found:
        torch.cuda.synchronize(dev)
    return result


def time_fn(fn, *args, iters=1, warmup=0, **kw):
    """(mean_seconds, last_result) with device fencing."""
    result = None
    for _ in range(warmup):
        result = _block(fn(*args, **kw))
    t0 = time.perf_counter()
    for _ in range(iters):
        result = _block(fn(*args, **kw))
    dt = (time.perf_counter() - t0) / max(1, iters)
    return dt, result


@dataclass
class BenchResult:
    build_ms: float = 0.0
    aabb_ms: float = 0.0
    memory_bytes: int = 0
    render_ms: float = 0.0
    mrays_per_s: float = 0.0
    runs: int = 0
    extra: dict = field(default_factory=dict)

    def summary(self) -> str:
        return (
            f"build {self.build_ms:.2f} ms | aabbs {self.aabb_ms:.2f} ms | "
            f"memory {self.memory_bytes} B | render {self.render_ms:.2f} ms"
            f" | {self.mrays_per_s:.1f} Mrays/s ({self.runs} runs)"
        )


class Benchmarker:
    """N-run averaged measurement of the voxelize/extract/render pipeline.

    Usage:
        b = Benchmarker(runs=10)
        res = b.measure_build(lambda: GridBool.from_mesh(v, f, vs))
        res = b.measure_render(lambda: render_scene(scene, cam), w, h, res)
    """

    def __init__(self, runs: int = 10, warmup: int = 1):
        self.runs = runs
        self.warmup = warmup

    def measure_build(self, build_fn, extract_fn=None,
                      result: BenchResult | None = None) -> BenchResult:
        res = result or BenchResult()
        res.runs = self.runs
        dt, grid = time_fn(build_fn, iters=self.runs, warmup=self.warmup)
        res.build_ms = dt * 1e3
        if hasattr(grid, "memory_usage_bytes"):
            res.memory_bytes = grid.memory_usage_bytes()
        if extract_fn is not None:
            dt, _ = time_fn(lambda: extract_fn(grid), iters=self.runs,
                            warmup=self.warmup)
            res.aabb_ms = dt * 1e3
        res.extra["grid"] = grid
        return res

    def measure_render(self, render_fn, width: int, height: int,
                       result: BenchResult | None = None) -> BenchResult:
        res = result or BenchResult()
        res.runs = self.runs
        dt, _ = time_fn(render_fn, iters=self.runs, warmup=max(1, self.warmup))
        res.render_ms = dt * 1e3
        res.mrays_per_s = (width * height) / dt / 1e6
        return res
