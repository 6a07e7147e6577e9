"""frame_ms: all the time of the window over the frames completed in it."""


def read(run):
    if not run.frame_s:
        return None
    return run.window_s / len(run.frame_s) * 1e3
