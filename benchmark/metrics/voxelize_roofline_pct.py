"""voxelize_roofline_pct: the voxelize kernels' (`kernels.voxelize`) share
of their bound over the traced window: each traced frame's least seconds
(vrbench/work.py voxelize_bound_s: the larger of its bytes over the HBM
peak and of its SAT tests, the cells of the reference's clamped windows
over that frame's own vertex set, over the float32 peak), summed, against
the kernels' device time.  The work is counted from the benchmark's
geometry and reference, never from the program."""
import torch

from vrbench import reference, work


def read(run):
    names = run.spec.config.get("kernels", {}).get("voxelize")
    if run.trace is None or not run.steps or not names:
        return None
    s = run.trace.seconds_of(names)
    if s <= 0:
        return None
    geo = run.geometry
    bb_min, _, vs, dims = geo.grid
    # counted on the card where there is one (the same float32 windows)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    cells = dims[0] * dims[1] * dims[2]
    tests = {}
    bound = 0.0
    for step in run.steps:
        key = geo.key(step)
        if key not in tests:
            tests[key] = reference.sat_tests(geo.sets[key], geo.faces,
                                             bb_min, vs, dims, dev)
        bound += work.voxelize_bound_s(len(geo.sets[key]), len(geo.faces),
                                       cells, tests[key])
    return 100.0 * bound / s
