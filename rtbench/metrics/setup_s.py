"""Seconds from the process's start to the window's opening: imports,
CUDA's start, the scene's build and upload, the kernels' build where it is
not cached, the graph's capture and the warm-up frames."""

SOURCE, UNIT, LAYER = "host_clock", "s", None


def read(run):
    return run.t_open - run.t_start
