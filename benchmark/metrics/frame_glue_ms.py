"""frame_glue_ms: device time a frame of PyTorch's operations in the
traced window (vrbench/profile.py's is_glue): the kernels of the tensor
ops of render.pipeline, render.shading and ops.intersect, and their copies
and fills; the program's own kernels left out.  Nothing when there is no
such operation."""


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    s = run.trace.glue_seconds()
    return s * 1e3 / run.traced_frames if s > 0 else None
