"""Spans and counters: the program's one recorder.

Counterpart of voxelray_tpu/utils/trace.py.  The reference's
observability is an FPS titlebar layer, an ImGui ms/frame readout,
chrono timers around build phases, and NSight debug labels (SURVEY.md
section 5).  Here:

  span(name)          a context manager recording one span: its name, the
                      enclosing span's index, its request (one id for each
                      top-level span: a render_image call, a set-up step),
                      start and end
  enable() / disable()
                      switch span recording on or off (off by default)
  records(), dropped(), clear()
                      the recorded spans, the spans dropped once the bound
                      was reached, and emptying both and every counter
  count(name, n)      a host counter, always on (kernel launches, rays a
                      kernel call is handed)
  count_device(name, x)
                      adds x.sum() to a device counter, with no host sync;
                      only while recording
  counter(name), counters(), reset_counters(prefix)
                      read and zero them (counters() reads the device
                      counters too: call it after a sync)
  dump(path)          the spans as Chrome-trace JSON, for Perfetto

Times are Unix-epoch nanoseconds, the clock of torch.profiler's
`kineto_results.trace_start_ns()`: perf_counter_ns plus one offset taken
at enable(), so that a span can be laid over the profiler's timeline.
Spans are kept in this module's memory, never as profiler ranges, NVTX
ranges or CUDA events: a profile of the program shows no span.

Off, span() is one module-level test returning a shared object whose
`with` block does nothing: no clock read, no allocation.
"""
from __future__ import annotations

import functools
import json
import os
import time
from typing import NamedTuple

import torch

__all__ = ["Span", "span", "spanned", "enable", "disable", "enabled",
           "records", "dropped", "clear", "clock_ns", "count",
           "count_device", "counter", "counters", "reset_counters", "dump",
           "CAPACITY"]

CAPACITY = 1 << 20      # spans kept before new ones are dropped


class Span(NamedTuple):
    name: str
    parent: int         # index in records() of the enclosing span; -1
    frame: int          # the request: its top-level span's number
    start_ns: int       # Unix-epoch ns
    end_ns: int


_on = False
_offset = 0             # Unix-epoch ns minus perf_counter_ns
_capacity = CAPACITY
_recs: list = []        # [name, parent, frame, start, end] while open
_stack: list = []       # indices of the open spans
_dropped = 0
_requests = 0
_counts: dict = {}
_device: dict = {}


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "rec", "i")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        global _dropped, _requests
        if len(_recs) >= _capacity:
            _dropped += 1
            self.rec = None
            return None
        if _stack:
            parent = _stack[-1]
            frame = _recs[parent][2]
        else:
            _requests += 1
            parent, frame = -1, _requests
        self.i = len(_recs)
        self.rec = [self.name, parent, frame, 0, 0]
        _recs.append(self.rec)
        _stack.append(self.i)
        self.rec[3] = time.perf_counter_ns() + _offset
        return None

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec[4] = time.perf_counter_ns() + _offset
            if _stack and _stack[-1] == self.i:
                _stack.pop()
        return False


def span(name: str):
    """`with span(name):` records the block as a span while recording is
    on, and does nothing otherwise."""
    if not _on:
        return _OFF
    return _On(name)


def spanned(name: str):
    """Decorator: each call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def _sample_offset():
    """Unix-epoch ns minus perf_counter_ns, from the tightest of a few
    bracketed readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def enable(capacity: int = CAPACITY):
    """Record spans from now on, at most `capacity` of them."""
    global _on, _offset, _capacity
    _offset = _sample_offset()
    _capacity = int(capacity)
    _on = True


def disable():
    """Stop recording; spans still open end as they close."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def clock_ns() -> int:
    """Now, on the spans' clock."""
    return time.perf_counter_ns() + _offset


def records() -> list:
    """The spans recorded since the last clear(), in the order they
    started.  A span still open has end_ns 0."""
    return [Span(*r) for r in _recs]


def dropped() -> int:
    """Spans not recorded since the last clear() because the bound was
    reached."""
    return _dropped


def clear():
    """Empty the spans, the drop count and every counter."""
    global _dropped
    _recs.clear()
    _stack.clear()
    _counts.clear()
    _device.clear()
    _dropped = 0


def count(name: str, n: int = 1):
    """Add n to the host counter `name` (always on)."""
    _counts[name] = _counts.get(name, 0) + n


def count_device(name: str, x):
    """While recording, add x.sum() (a device tensor) to the device counter
    `name`, with no host sync; nothing otherwise."""
    if not _on:
        return
    s = x.sum(dtype=torch.int64)
    acc = _device.get(name)
    if acc is None:
        _device[name] = s
    else:
        acc.add_(s)


def counter(name: str) -> int:
    """The host counter `name` (0 if never counted)."""
    return _counts.get(name, 0)


def counters() -> dict:
    """Every counter, host and device, as ints: the device counters are
    read from the device, so call it after a sync."""
    out = dict(_counts)
    for name, acc in _device.items():
        out[name] = out.get(name, 0) + int(acc)
    return out


def reset_counters(prefix: str = ""):
    """Zero the host counters whose name starts with `prefix`."""
    for name in [k for k in _counts if k.startswith(prefix)]:
        del _counts[name]


def dump(path):
    """Write the spans as Chrome-trace JSON ("X" events; ts and dur in
    microseconds, ts on the Unix epoch: a torch.profiler trace's ts plus
    its baseTimeNanoseconds / 1000).  Each event's args hold its index,
    parent and frame; the file's otherData the counters and the drop
    count."""
    pid = os.getpid()
    events = [{"name": r.name, "ph": "X", "pid": pid, "tid": 0,
               "ts": r.start_ns / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
               "args": {"index": i, "parent": r.parent, "frame": r.frame}}
              for i, r in enumerate(records())]
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "baseTimeNanoseconds": 0,
                   "otherData": {"dropped": _dropped,
                                 "counters": counters()}}, fh)
