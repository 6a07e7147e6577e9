"""tri_row_fill_pct: the share of the triangle accel's row slots (rows x
l_width, the table tri_march reads) that hold a triangle: the program's
counters tri_accel.pairs over tri_accel.row_slots, which each rebuild
takes from its one sizing copy, over the frames of the spans window's pass
(a) (vrbench/spans.py).  Nothing without those counters."""
from vrbench import spans


def read(run):
    s = spans.of(run)
    if s is None or not s.counters.get("tri_accel.row_slots"):
        return None
    return 100.0 * s.counters.get("tri_accel.pairs", 0) \
        / s.counters["tri_accel.row_slots"]
