"""The 95th percentile, over every frame of the window, of the wall ms
between consecutive frame ends (the first from the window's opening)."""

import numpy as np

SOURCE, UNIT, LAYER = "host_clock", "ms", None


def read(run):
    if not run.frames:
        return None
    ends = np.asarray([run.t_open, *run.frames])
    return float(np.percentile(np.diff(ends), 95)) * 1000.0
