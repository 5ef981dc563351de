"""Wall ms a frame: the window's wall time over the frames it completed
(a frame ends at a sync after a sweep, or at a ``display.flip``)."""

SOURCE, UNIT, LAYER = "host_clock", "ms", None


def read(run):
    if not run.frames:
        return None
    return (run.frames[-1] - run.t_open) * 1000.0 / len(run.frames)
