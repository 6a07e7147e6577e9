"""trace_kernel_ms: device time a frame of the trace kernels that the
configuration lists (`kernels.trace`): K2 (mega_trace) on the voxel scene,
tri_march on the triangle scene.  Nothing when none of them ran."""


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    s = run.trace.seconds_of(run.spec.config["kernels"]["trace"])
    return s * 1e3 / run.traced_frames if s > 0 else None
