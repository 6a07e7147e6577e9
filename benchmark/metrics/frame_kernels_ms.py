"""frame_kernels_ms: device time a frame of the frame glue's kernels that
the configuration lists (`kernels.frame`: camera_rays, hit_surface,
shade_post) in the traced window.  Nothing when none of them ran."""


def read(run):
    names = run.spec.config.get("kernels", {}).get("frame")
    if run.trace is None or not run.traced_frames or not names:
        return None
    s = run.trace.seconds_of(names)
    return s * 1e3 / run.traced_frames if s > 0 else None
