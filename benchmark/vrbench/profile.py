"""Reading the device trace of the traced window, and the host syncs.

The arithmetic is copied so that a change to the program cannot move it:

  busy_seconds   the device's busy time as the union of its operations'
                 intervals: scripts/torch_frame_profile.py:33-47 (busy_ms),
                 here clipped to the traced window
  launches       kernels counted by name from the profiler's device
                 events: scripts/torch_frame_profile.py:50-79
  host_syncs     the syncs a call makes, as file:line, under
                 torch.cuda.set_sync_debug_mode("warn"): chip_smoke.py:1340

A device operation is glue or the program's own by where it comes from:
PyTorch's kernels (its namespaces at, at_cuda_detail and c10, and the cub
and thrust it builds its sorts and scans from) and its copies and fills
are the glue of the program's tensor ops; every other kernel is the
program's own, hand-written code.  No list of the program's kernels is
kept, so a kernel that a later change adds is counted as its own.

A device operation is put down to the call that launched it by the
profiler's correlation id, which a CUDA runtime call on the host (a
launch, a copy, a fill) shares with the operation it queued: in a window
with the host traced, the operations whose runtime call began inside a
span of the benchmark's own (`vrbench.<name>`, program.Program.call) are
that call's.

Nothing here imports the program.
"""
from __future__ import annotations

import bisect
import os
import re
import warnings

import torch

__all__ = ["busy_seconds", "is_glue", "Trace", "host_syncs",
           "WINDOW_SPAN"]

WINDOW_SPAN = "vrbench.window"
# the benchmark's own spans (the window, Program.call's) and the
# profiler's steps, which it also shows on the device's timeline, as
# annotations: no device operation
ANNOTATIONS = ("vrbench.", "ProfilerStep#")
NOT_KERNELS = ("Memcpy", "Memset")
TORCH_CODE = re.compile(
    r"(?:^|[^\w:])(?:at|at_cuda_detail|c10|cub|thrust)::")
# host events that say what the host was doing: PyTorch's ops and the
# CUDA runtime's calls (not the profiler's own bookkeeping)
HOST_OPS = ("aten::", "cuda")
LOOK_BACK = 64          # host events searched for a gap's innermost one


def _union(spans):
    """The union of (start, end) intervals, sorted and merged."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def is_glue(name):
    """Whether a device operation is PyTorch's: one of its kernels, or a
    copy or fill."""
    return name.startswith(NOT_KERNELS) or bool(TORCH_CODE.search(name))


def busy_seconds(spans, lo=None, hi=None):
    """Length in seconds of the union of (start_us, end_us) intervals,
    clipped to [lo, hi] microseconds when given."""
    total = 0.0
    for s, e in _union(spans):
        if lo is not None:
            s, e = max(s, lo), min(e, hi)
        total += max(0.0, e - s)
    return total / 1e6


class Trace:
    """The device operations and host events of a profiled window.

    prof: a finished torch.profiler.profile.  With host activity traced,
    the window is its one record_function(WINDOW_SPAN) span; a trace of
    the device alone (whose host overhead is small) takes `window_s`,
    the window's length on the host clock, and holds no host events.
    Times are microseconds of the profiler's clock.
    """

    def __init__(self, prof, window_s=None):
        events = list(prof.events())
        cuda = torch.autograd.DeviceType.CUDA
        dev = [e for e in events if e.device_type == cuda
               and not e.name.startswith(ANNOTATIONS)]
        ops = [(e.name, e.time_range.start, e.time_range.end) for e in dev]
        win = [e for e in events
               if e.name == WINDOW_SPAN and e.device_type != cuda]
        if win:
            self.lo, self.hi = win[0].time_range.start, win[0].time_range.end
        elif window_s is not None:
            self.lo = min((s for _, s, _ in ops), default=0.0)
            self.hi = self.lo + window_s * 1e6
        else:
            raise RuntimeError("the traced window has no span and no "
                               "length")
        inside = [o[2] > self.lo and o[1] < self.hi for o in ops]
        self.device_ops = [o for o, k in zip(ops, inside) if k]
        # correlation ids of the device operations, and the host's CUDA
        # runtime calls and own spans, for launched_in
        self._op_ids = [e.id for e, k in zip(dev, inside) if k]
        host_ev = [e for e in events if e.device_type != cuda]
        self._runtime = [(e.time_range.start, e.id) for e in host_ev
                         if e.name.startswith("cuda")]
        self._spans = [(e.name, e.time_range.start, e.time_range.end)
                       for e in host_ev if e.name.startswith("vrbench.")]
        host = sorted((e.time_range.start, e.time_range.end, e.name)
                      for e in events if e.device_type != cuda
                      and e.name.startswith(HOST_OPS))
        self._host = host
        self._host_starts = [h[0] for h in host]

    @property
    def window_s(self):
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self):
        return busy_seconds([(s, e) for _, s, e in self.device_ops],
                            self.lo, self.hi)

    def kernels(self):
        """Device kernels (no copies or fills): [(name, start, end)]."""
        return [k for k in self.device_ops
                if not k[0].startswith(NOT_KERNELS)]

    def glue_seconds(self):
        """Summed device seconds of PyTorch's operations (is_glue)."""
        return sum(e - s for n, s, e in self.device_ops
                   if is_glue(n)) / 1e6

    def hand_kernels(self):
        """Names of the program's own kernels that ran, one a launch."""
        return [n for n, _, _ in self.device_ops if not is_glue(n)]

    def seconds_of(self, names):
        """Summed device seconds of the kernels whose name holds one of
        `names`."""
        return sum(e - s for n, s, e in self.kernels()
                   if any(x in n for x in names)) / 1e6

    def launched_in(self, name):
        """Summed device seconds of the operations (kernels, copies and
        fills) whose CUDA runtime call began inside a host span
        `vrbench.<name>`; None where the window holds no such span or no
        operation linked to one."""
        spans = sorted((s, e) for n, s, e in self._spans
                       if n == f"vrbench.{name}")
        if not spans:
            return None
        starts = [s for s, _ in spans]
        ids = set()
        for t, cid in self._runtime:
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t <= spans[k][1]:
                ids.add(cid)
        total = sum(e - s for (_, s, e), cid in zip(self.device_ops,
                                                     self._op_ids)
                    if cid in ids)
        return total / 1e6 if total > 0 else None

    def top_ops(self, k=10):
        """[(name, seconds)] of the device operations that took most time,
        summed by name."""
        by = {}
        for n, s, e in self.device_ops:
            by[n] = by.get(n, 0.0) + (min(e, self.hi) - max(s, self.lo))
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], t / 1e6] for n, t in top]

    def _host_at(self, t):
        """What the host was doing at time t: the innermost PyTorch op and,
        inside it, a CUDA runtime call."""
        i = bisect.bisect_right(self._host_starts, t)
        op, call = None, None
        for s, e, name in reversed(self._host[max(0, i - LOOK_BACK):i]):
            if e < t:
                continue
            if name.startswith("cuda") and call is None and op is None:
                call = name
            elif not name.startswith("cuda"):
                op = name
                break
        if op is None and call is None:
            return "host, between profiled ops"
        return op if call is None else f"{op or '-'} > {call}"

    def idle_gaps(self, k=10):
        """[(what the host was doing, seconds)]: the window's idle time,
        summed by the host's activity at each gap's midpoint, the largest
        k."""
        busy = _union([(max(s, self.lo), min(e, self.hi))
                       for _, s, e in self.device_ops])
        edges = [self.lo] + [x for iv in busy for x in iv] + [self.hi]
        by = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                what = self._host_at(0.5 * (a + b))
                by[what] = by.get(what, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], t / 1e6] for n, t in top]


def host_syncs(fn, device):
    """The host syncs fn() makes on the card: file:line of each call that
    synced, under sync debug mode "warn".  A known sync is counted first,
    to show that the warnings arrive."""
    def sites():
        return [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in rec
                if "called a synchronizing CUDA operation" in str(w.message)]

    torch.cuda.synchronize(device)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            int(torch.ones(1, device=device).sum())
            if len(sites()) != 1:
                raise RuntimeError("sync debug mode: a known sync was not "
                                   "reported")
            del rec[:]
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize(device)
        return sites()
