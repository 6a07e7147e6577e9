"""trace_roofline_pct: the trace kernels' share of their bytes bound, the
rays' bytes (vrbench/work.py: every primary ray and every shadow ray that
the reference admits, read once and answered once) over the HBM peak,
against the kernels' device time in the traced window."""
from vrbench import work


def read(run):
    if run.trace is None or not run.admitted:
        return None
    s = run.trace.seconds_of(run.spec.config["kernels"]["trace"])
    if s <= 0:
        return None
    cfg = run.spec.config
    nbytes = work.trace_bytes(cfg["width"], cfg["height"], run.admitted)
    return 100.0 * nbytes / work.peak("hbm_bytes_per_s") / s
