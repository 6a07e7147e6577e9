"""scene_build_ms: device time a frame of the operations (kernels, copies
and fills) launched while the step's build_scene call is open: in the
window traced with the host (`host_trace_frames` frames), each operation
put down to its launch by the profiler's correlation id, its CUDA runtime
call begun inside the benchmark's span around build_scene
(vrbench/profile.py launched_in).  Nothing where no frame builds a scene."""


def read(run):
    if run.host_trace is None:
        return None
    s = run.host_trace.launched_in("build_scene")
    if s is None:
        return None
    return s * 1e3 / int(run.spec.traffic["host_trace_frames"])
