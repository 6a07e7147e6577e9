"""Tracing / profiling subsystem.

Counterpart of voxelray_tpu/utils/trace.py.  The reference's
observability is an FPS titlebar layer, an ImGui ms/frame readout,
chrono timers around build phases, and NSight debug labels (SURVEY.md
section 5).  Equivalents here:

  phase(name)        context manager timing a build/render phase with
                     device fencing (the chrono timers)
  profile_trace(dir) torch.profiler capture of the CPU and, where there
                     is a card, the CUDA activity; writes a Chrome trace
                     (the NSight equivalent)
  annotate(name)     torch.profiler.record_function, a labelled region
                     inside a trace (the vkCmdDebugMarker equivalent)
  FrameStats         rolling ms/frame + FPS aggregator (the ImGui readout)
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import torch

from .logging import log_event
from .timing import _block

__all__ = ["phase", "profile_trace", "annotate", "FrameStats"]


@contextlib.contextmanager
def phase(name: str, log: bool = True):
    """Wall-clock a phase with device fencing; logs a structured event.
    Tensors the caller stashes in the yielded dict are waited for."""
    t0 = time.perf_counter()
    holder = {}
    try:
        yield holder
    finally:
        _block(list(holder.values()))
        dt = time.perf_counter() - t0
        holder["seconds"] = dt
        if log:
            log_event("phase", name=name, ms=round(dt * 1e3, 3))


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a torch.profiler trace; on exit writes
    <log_dir>/trace.json (open in chrome://tracing or Perfetto).  Yields
    the profiler, whose key_averages() sums the time by op and kernel."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Label a region inside a profiler trace."""
    return torch.profiler.record_function(name)


class FrameStats:
    """Rolling average ms/frame + FPS, like the ImGui overlay."""

    def __init__(self, window: int = 64):
        self.samples: deque[float] = deque(maxlen=window)
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.samples.append(now - self._last)
        self._last = now

    @property
    def ms_per_frame(self) -> float:
        if not self.samples:
            return 0.0
        return sum(self.samples) / len(self.samples) * 1e3

    @property
    def fps(self) -> float:
        ms = self.ms_per_frame
        return 1000.0 / ms if ms > 0 else 0.0

    def summary(self) -> str:
        return (f"Application average {self.ms_per_frame:.3f} ms/frame "
                f"({self.fps:.1f} FPS)")
