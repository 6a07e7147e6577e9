"""host_syncs_per_frame: the host syncs that frames after the traced
window make (sync debug mode "warn"), over those frames."""


def read(run):
    if not run.sync_frames or run.trace is None:
        return None
    return len(run.sync_sites) / run.sync_frames
