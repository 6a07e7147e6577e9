"""kernel_call_host_ms: the host time a frame inside the program's
kernel-call spans (mega_trace, staged_march, tri_march: the wrapper's
argument checks, its output and counter allocations, the launch), over the
frames of the spans window's pass (a) (vrbench/spans.py).  Nothing without
such spans."""
from vrbench import spans


def read(run):
    s = spans.of(run)
    if s is None:
        return None
    ns = spans.kernel_call_ns(s.recs)
    return ns / s.frames / 1e6 if ns > 0 else None
