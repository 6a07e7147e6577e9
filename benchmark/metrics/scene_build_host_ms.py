"""scene_build_host_ms: host time a frame of the step's build_scene call,
all it calls included (build_accel, build_fine_sb, extract_aabbs and its
sync), over the traced frames flown untraced (Run.call_s).  Nothing where
no frame builds a scene."""


def read(run):
    s = run.call_s.get("build_scene")
    if not s or not run.traced_frames:
        return None
    return s * 1e3 / run.traced_frames
