"""frame_p95_ms: the 95th percentile of every frame of the window, each
from the start of its first call to the device sync that ends it (numpy's
linear-interpolation percentile)."""
import numpy as np


def read(run):
    if not run.frame_s:
        return None
    return float(np.percentile(np.asarray(run.frame_s, np.float64), 95)) \
        * 1e3
