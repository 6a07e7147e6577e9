"""tri_bin_roofline_pct: the binning kernels' (`kernels.tri_build`) share
of their bound over the traced window: each traced frame's least seconds
(vrbench/tri_work.py bin_bound_s: the larger of its bytes, the vertex set
and faces read once and 8 bytes a (triangle, cell) hit and 4 a cell
written, over the HBM peak, and of its SAT tests in the clamped windows
of the tri grid over the float32 peak, both from that frame's own vertex
set), summed, against the kernels' device time.  The work and the grid
are counted from the benchmark's geometry and reference, never from the
program."""
import torch

from vrbench import tri_work


def read(run):
    names = run.spec.config.get("kernels", {}).get("tri_build")
    if run.trace is None or not run.steps or not names:
        return None
    s = run.trace.seconds_of(names)
    if s <= 0:
        return None
    geo = run.geometry
    grid = tri_work.tri_grid(geo)
    # counted on the card where there is one (the same float32 windows)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    bounds = {}
    for step in run.steps:
        key = geo.key(step)
        if key not in bounds:
            bounds[key] = tri_work.bin_bound_s(geo.sets[key], geo.faces,
                                               grid, dev)
    return 100.0 * sum(bounds[geo.key(step)] for step in run.steps) / s
