"""tri_bin_kernel_ms: device time a frame of the triangle accel's binning
kernels that the configuration lists (`kernels.tri_build`: tri_bin's count
and emit passes) in the traced window.  Nothing when the configuration
lists none or none ran."""


def read(run):
    names = run.spec.config.get("kernels", {}).get("tri_build")
    if run.trace is None or not run.traced_frames or not names:
        return None
    s = run.trace.seconds_of(names)
    return s * 1e3 / run.traced_frames if s > 0 else None
