"""glue_idle_ms: the device's idle time a frame that the frame glue's host
work causes: the share of the spans window's pass (b) idle time (profiled,
CUDA activity alone) whose gaps fall, by their midpoint, in the self time
of the program's render_image span or a stage span, times pass (a)'s idle
time, its seconds less pass (b)'s busy seconds, as device_idle_pct scales
it, so that CUPTI's cost a launch does not widen it (vrbench/spans.py).
Nothing without the program's spans or a device trace."""
from vrbench import spans


def read(run):
    s = spans.of(run)
    if s is None or not s.traced:
        return None
    idle = spans.idle_by_span(s.dev_recs, s.ops, s.lo, s.hi)
    total = sum(idle.values())
    if total <= 0:
        return None
    glue = sum(idle.get(n, 0) for n in spans.GLUE)
    return glue / total * (s.on_s - spans.busy_s(s)) / s.frames * 1e3
