"""Ms a frame in the traced window during which the card ran nothing while
the host was inside the program's span ``sync.wait``
(``torch.cuda.synchronize`` in ``profiling.device_sync``):
``program.idle_ms``, None where the window held a capture or a build."""

from rtbench import program

SOURCE, UNIT = "device_trace", "ms"
LAYER = "Device"
MOVES = "frame_ms"


def read(run):
    return program.idle_ms(run, "sync.wait")
