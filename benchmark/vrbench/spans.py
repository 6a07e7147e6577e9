"""The program's own spans and counters over a traced run's frames.

voxelray_torch records, with its tracing on (voxelray_torch/utils/trace.py),
a span for each render_image call, one for each of its stages (FRAME,
STAGES) and one for each call of a trace kernel inside a stage, on the
Unix-epoch clock that torch.profiler's trace_start_ns() counts in; and
counters, among them the shadow rays handed to the shadow traces and those
of them admitted.  This module reads them.

The harness's own windows run with the program's tracing off, so the
metrics they give read what they read without it.  The readers of the
span metrics call `of(run)`, which, once for a traced run, builds the
cell's program again, the program's tracing on around its set-up (the
set-up spans are logged), and flies the traced run's cameras from the
orbit's first camera (the run's seed picks another start; the cameras are
spread over the orbit as the run's are):

  pass (a)  round by round, each round once with the program's tracing on
            and once off, in turns: the spans and counters, and the
            host's times without CUPTI's cost a launch; the rounds off
            give the cost of tracing
  pass (b)  with tracing on, under torch.profiler with CUDA activity
            alone, after the warm-up step the traced window takes: the
            device operations, brought onto the spans' clock by marks

The profiler's device timestamps do not keep to the host's clock: on an
H100 they stood from -0.15 to +1.7 ms off the launches that caused them,
drifting by up to a millisecond in a second.  So before each frame of pass
(b), and after the last, the host stamps the spans' clock and launches one
marker kernel (MARK) on the idle device, and each device time is mapped,
piecewise linearly, from the markers' device starts onto those stamps.

From them: each stage's host self time a frame; each idle gap of pass (b)
put down, by its midpoint, to the innermost program span open on the host
then, or to OUTSIDE; and the clock check, each trace kernel's device start
less its kernel-call span's start, frame by frame, which the mapping keeps
from going negative by more than a marker's launch latency.  A program
without the recorder gives nothing.

Nothing here imports the program but through program.py.
"""
from __future__ import annotations

import bisect
import statistics
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import inputs, profile
from .program import kind_of, load_kernels

__all__ = ["FRAME", "STAGES", "OUTSIDE", "KERNELS", "MARK", "Spans",
           "recorder", "spans_window", "of", "host_self_ns",
           "glue_host_ns", "kernel_call_ns", "idle_by_span", "busy_s",
           "align", "clock_offsets"]

FRAME = "render_image"
STAGES = ("rays", "primary", "surface", "shadow", "shade", "post")
GLUE = (FRAME,) + STAGES
OUTSIDE = "outside render_image"
# a kernel-call span and the device kernel it launches
KERNELS = {"mega_trace": "mega_trace_kernel",
           "staged_march": "staged_march_kernel",
           "tri_march": "tri_march_kernel"}
RECORDER = ("enable", "disable", "records", "counters", "clear", "clock_ns")
MARK = "spin_kernel"    # torch.cuda._sleep's kernel, which no frame runs
MARK_CYCLES = 100


def log(msg):
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Spans:
    """What the spans window measured.  Times are ns of the spans' clock."""

    frames: int = 0
    on_s: float = 0.0           # pass (a): the frames with tracing on
    off_s: float = 0.0          # ... and the same frames with it off
    recs: list = field(default_factory=list)        # pass (a)'s spans
    counters: dict = field(default_factory=dict)    # ... and counters
    dev_recs: list = field(default_factory=list)    # pass (b)'s spans
    ops: list = field(default_factory=list)  # (name, start, end) of (b)
    marks: list = field(default_factory=list)   # (b)'s host stamps
    skew: list = field(default_factory=list)    # markers' device - host
    lo: int = 0                 # pass (b)'s window, its first and last mark
    hi: int = 0

    @property
    def traced(self):
        """Whether pass (b) ran (on the card)."""
        return self.hi > self.lo


def recorder():
    """The program's span recorder, or None where it has none."""
    try:
        from voxelray_torch.utils import trace
    except ImportError:
        return None
    return trace if all(hasattr(trace, a) for a in RECORDER) else None


# ---- the arithmetic, on records (name, parent, frame, start_ns, end_ns) --

def _in_frames(recs):
    """Indices of the records inside a FRAME span (the frame included)."""
    inside = []
    for i, r in enumerate(recs):
        p = i
        while p >= 0 and recs[p].name != FRAME:
            p = recs[p].parent
        if p >= 0:
            inside.append(i)
    return inside


def host_self_ns(recs):
    """{span name: summed self time} of the spans inside frames: its
    length less its children's."""
    own = {i: recs[i].end_ns - recs[i].start_ns for i in _in_frames(recs)}
    for i in list(own):
        p = recs[i].parent
        if p in own:
            own[p] -= recs[i].end_ns - recs[i].start_ns
    out = {}
    for i, t in own.items():
        out[recs[i].name] = out.get(recs[i].name, 0) + t
    return out


def glue_host_ns(recs):
    """The frames' glue host time: the self time of the frame spans and
    their stage spans (the kernel-call spans inside them left out)."""
    own = host_self_ns(recs)
    return sum(own.get(n, 0) for n in GLUE)


def kernel_call_ns(recs):
    """The host time inside the kernel-call spans of the frames: the
    outermost spans under a frame or stage span that are not stages."""
    total = 0
    for i in _in_frames(recs):
        r = recs[i]
        if r.name not in GLUE and r.parent >= 0 \
                and recs[r.parent].name in GLUE:
            total += r.end_ns - r.start_ns
    return total


def _innermost(recs, starts, t):
    """Name of the innermost span open at t, or OUTSIDE.  recs are in
    start order and properly nested, so the innermost one is the latest
    started span, or one of its ancestors, that has not ended."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if recs[i].end_ns >= t:
            return recs[i].name
        i = recs[i].parent
    return OUTSIDE


def idle_by_span(recs, ops, lo, hi):
    """{span name or OUTSIDE: idle ns}: the gaps between the device
    operations' union within [lo, hi], each put down by its midpoint to
    the innermost span open on the host.  A span name outside every frame
    counts as OUTSIDE."""
    starts = [r.start_ns for r in recs]
    busy = profile._union([(max(s, lo), min(e, hi)) for _, s, e in ops
                           if e > lo and s < hi])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    framed = {recs[i].name for i in _in_frames(recs)}
    out = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            what = _innermost(recs, starts, 0.5 * (a + b))
            what = what if what in framed else OUTSIDE
            out[what] = out.get(what, 0) + (b - a)
    return out


def busy_s(s):
    """Pass (b)'s device busy seconds: the union of its operations within
    its window."""
    return profile.busy_seconds([(a / 1e3, b / 1e3) for _, a, b in s.ops],
                                s.lo / 1e3, s.hi / 1e3)


def _match(dev, marks, gap=4):
    """The stamp index of each marker the profiler kept (it loses a record
    now and then): the increasing matching, at most gap - 1 stamps passed
    over between two markers, along which the markers' device start less
    their stamp changes least.  That difference drifts by microseconds
    from one frame to the next, and a frame lasts milliseconds."""
    n, m = len(dev), len(marks)
    cost = [[float("inf")] * m for _ in range(n)]
    back = [[-1] * m for _ in range(n)]
    for k in range(min(gap, m)):
        cost[0][k] = 0.0
    for j in range(1, n):
        for k in range(j, m):
            for kp in range(max(j - 1, k - gap), k):
                c = cost[j - 1][kp]
                if c == float("inf"):
                    continue
                c += abs((dev[j] - marks[k]) - (dev[j - 1] - marks[kp]))
                if c < cost[j][k]:
                    cost[j][k], back[j][k] = c, kp
    k = min(range(m), key=lambda i: cost[n - 1][i])
    if cost[n - 1][k] == float("inf"):
        return None
    out = [k]
    for j in range(n - 1, 0, -1):
        k = back[j][k]
        out.append(k)
    return out[::-1]


def align(ops, marks):
    """(ops on the spans' clock, without the markers; each kept marker's
    device start less its host stamp): the device times mapped piecewise
    linearly from the MARK kernels' starts onto `marks`, the host stamps
    taken as each was launched.  (None, []) with fewer than two markers
    kept."""
    dev = sorted(s for n, s, _ in ops if MARK in n)
    at = _match(dev, marks) if 2 <= len(dev) <= len(marks) else None
    if at is None:
        return None, []
    marks = [marks[k] for k in at]
    t0 = marks[0]
    xp = np.asarray(dev, np.int64) - t0
    fp = np.asarray(marks, np.int64) - t0
    rest = [o for o in ops if MARK not in o[0]]

    def onto(ts):
        return np.interp(np.asarray(ts, np.int64) - t0, xp, fp) + t0

    starts = onto([s for _, s, _ in rest])
    ends = onto([e for _, _, e in rest])
    return ([(o[0], int(a), int(b)) for o, a, b in zip(rest, starts, ends)],
            [d - h for d, h in zip(dev, marks)])


def clock_offsets(recs, ops, bounds):
    """{kernel-call span name: [device start - span start, ns]}: between
    each two of `bounds` (the marks), the n-th span of a name matched to
    the n-th launch of its kernel; where the two differ in number (the
    profiler lost a record) that stretch is left out."""
    out = {}
    for call, kernel in KERNELS.items():
        spans = [r.start_ns for r in recs if r.name == call]
        runs = sorted(s for n, s, _ in ops if kernel in n)
        for a, b in zip(bounds[:-1], bounds[1:]):
            sp = spans[bisect.bisect_left(spans, a):bisect.bisect_left(
                spans, b)]
            ks = runs[bisect.bisect_left(runs, a):bisect.bisect_left(runs, b)]
            if sp and len(sp) == len(ks):
                out.setdefault(call, []).extend(k - s for s, k in
                                                zip(sp, ks))
    return out


# ---- the window ----------------------------------------------------------

def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fly(prog, flight, shadows, frames, device):
    t0 = time.perf_counter()
    for i in frames:
        prog.frame_of(flight, i, shadows)
        _sync(device)
    return time.perf_counter() - t0


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def spans_window(prog, flight, shadows, frames, device, warm=None,
                 rounds=1, rec=None):
    """Fly `frames` (window frame indices, `rounds` rounds of equal length)
    with the program's tracing, as the module docstring sets out; `warm`:
    the frames of pass (b)'s profiler warm-up step.  Returns Spans, or
    None where the program has no recorder."""
    rec = rec or recorder()
    if rec is None:
        return None
    per = len(frames) // rounds
    out = Spans(frames=per * rounds)
    counters = {}
    rec.clear()
    for k in range(rounds):
        part = frames[k * per:(k + 1) * per]
        for on in ((True, False) if k % 2 == 0 else (False, True)):
            before = rec.counters()
            if on:
                rec.enable()
                out.on_s += _fly(prog, flight, shadows, part, device)
                rec.disable()
                for n, v in _delta(rec.counters(), before).items():
                    counters[n] = counters.get(n, 0) + v
            else:
                out.off_s += _fly(prog, flight, shadows, part, device)
    out.recs, out.counters = rec.records(), counters
    rec.clear()
    if device.type != "cuda":
        return out
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import schedule
    steps = schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch_profile(activities=[ProfilerActivity.CUDA],
                       schedule=steps) as prof:
        _fly(prog, flight, shadows, warm or frames[:1], device)
        prof.step()
        rec.enable()
        for i in list(frames) + [None]:
            torch.cuda._sleep(MARK_CYCLES)
            out.marks.append(rec.clock_ns())
            if i is not None:
                prog.frame_of(flight, i, shadows)
            _sync(device)
        rec.disable()
        prof.step()
    base = prof.profiler.kineto_results.trace_start_ns()
    cuda = torch.autograd.DeviceType.CUDA
    raw = sorted((e.name, base + round(e.time_range.start * 1e3),
                  base + round(e.time_range.end * 1e3))
                 for e in prof.events() if e.device_type == cuda
                 and not e.name.startswith(profile.ANNOTATIONS))
    ops, out.skew = align(raw, out.marks)
    kept = sum(MARK in n for n, _, _ in raw)
    if kept != len(out.marks):
        log(f"spans: the profiler kept {kept} of {len(out.marks)} marks")
    if ops is None:
        log("spans: pass (b)'s device times left out")
    else:
        out.ops, out.lo, out.hi = ops, out.marks[0], out.marks[-1]
    out.dev_recs = rec.records()
    rec.clear()
    return out


def _table(s):
    """Log the per-stage host and idle times a frame, the clock check and
    the cost of tracing."""
    n = max(1, s.frames)
    own = host_self_ns(s.recs)
    idle = idle_by_span(s.dev_recs, s.ops, s.lo, s.hi) if s.traced else {}
    names = list(GLUE) + sorted(set(own) - set(GLUE)) + [OUTSIDE]
    log(f"spans: {n} frames; ms a frame, host self (pass a) / idle (pass "
        f"b, {'traced' if s.traced else 'not traced'})")
    for name in names:
        if name in own or name in idle:
            log(f"spans:   {name:<22} {own.get(name, 0) / n / 1e6:9.4f} / "
                f"{idle.get(name, 0) / n / 1e6:9.4f}")
    log(f"spans: glue {glue_host_ns(s.recs) / n / 1e6:.4f} ms, kernel calls "
        f"{kernel_call_ns(s.recs) / n / 1e6:.4f} ms a frame; tracing on "
        f"{s.on_s:.6f} s, off {s.off_s:.6f} s "
        f"({100 * (s.on_s / s.off_s - 1) if s.off_s else 0:+.2f}%); "
        f"counters {dict(sorted(s.counters.items()))}")
    if s.skew:
        log(f"spans: profiler's device clock less the spans' at the marks: "
            f"{min(s.skew) / 1e3:.3f} to {max(s.skew) / 1e3:.3f} us, first "
            f"{s.skew[0] / 1e3:.3f}, last {s.skew[-1] / 1e3:.3f}")
    for call, d in clock_offsets(s.dev_recs, s.ops, s.marks).items():
        log(f"spans: clock check {call}: {len(d)} launches, device start "
            f"less span start min {min(d) / 1e3:.3f} us, median "
            f"{statistics.median(d) / 1e3:.3f} us")


def _measure(spec, rec):
    """Build the cell's program and fly the spans window over the traced
    run's cameras."""
    cfg, tr = spec.config, spec.traffic
    device = (torch.device("cuda", 0) if torch.cuda.is_available()
              else torch.device("cpu"))
    t0 = time.perf_counter()
    load_kernels(device)
    kind = kind_of(cfg)
    geo = kind.geometry(cfg)
    n = int(tr["trace_frames"])
    spread = [i * max(1, int(tr["cameras"]) // n) for i in range(n)]
    flight = inputs.Flight(tr, *geo.bbox, cfg["width"], cfg["height"],
                           0, spread)
    flight.start = 0
    rec.clear()
    rec.enable()
    prog = kind.Program(cfg, geo, device)
    _sync(device)
    rec.disable()
    for r in rec.records():
        log(f"spans: set-up {'  ' * _depth(rec.records(), r)}{r.name} "
            f"{(r.end_ns - r.start_ns) / 1e6:.3f} ms")
    rec.clear()
    t1 = time.perf_counter()
    shadows = bool(tr["shadows"])
    half = max(1, flight.n // max(1, 2 * n))
    for i in spread + [i + half for i in spread]:
        prog.frame_of(flight, i, shadows)
    _sync(device)
    rounds = int(tr["trace_rounds"])
    s = spans_window(prog, flight, shadows, spread * rounds, device,
                     warm=[i + half for i in spread], rounds=rounds, rec=rec)
    prog.free()
    del prog
    if device.type == "cuda":
        torch.cuda.empty_cache()
    _table(s)
    log(f"spans: {time.perf_counter() - t0:.3f} s in all, the program's "
        f"set-up {t1 - t0:.3f} s")
    return s


def _depth(recs, r):
    d = 0
    while r.parent >= 0:
        r, d = recs[r.parent], d + 1
    return d


def of(run):
    """The Spans of a traced run, measured at the first call and kept on
    the run; None for a run that flew no traced window (run_cell's trace
    branch sets host_trace) and where the program has no recorder."""
    if "spans" in vars(run):
        return run.spans
    run.spans = None
    if run.trace is None or run.host_trace is None:
        return None
    rec = recorder()
    if rec is None:
        log("spans: the program records no spans")
        return None
    run.spans = _measure(run.spec, rec)
    return run.spans
