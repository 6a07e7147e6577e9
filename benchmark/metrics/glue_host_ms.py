"""glue_host_ms: the frame glue's host time a frame: the self time of the
program's render_image span and its six stage spans, the kernel-call spans
inside them left out, over the frames of the spans window's pass (a) with
the program's tracing on (vrbench/spans.py).  Nothing without the
program's spans."""
from vrbench import spans


def read(run):
    s = spans.of(run)
    if s is None or not s.recs:
        return None
    return spans.glue_host_ns(s.recs) / s.frames / 1e6
