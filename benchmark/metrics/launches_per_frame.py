"""launches_per_frame: device kernels (copies and fills left out) launched
in the traced window, over its frames."""


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    return len(run.trace.kernels()) / run.traced_frames
