"""shadow_useful_pct: the share of the rays handed to the shadow pass's
traces that the frame admitted (hit and facing the light): the program's
counters shadow.admitted over shadow.rays, over the frames of the spans
window's pass (a) (vrbench/spans.py).  Nothing without those counters."""
from vrbench import spans


def read(run):
    s = spans.of(run)
    if s is None or not s.counters.get("shadow.rays"):
        return None
    return 100.0 * s.counters.get("shadow.admitted", 0) \
        / s.counters["shadow.rays"]
