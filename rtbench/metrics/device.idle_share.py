"""Share of the traced window in which no kernel, copy or set ran on the
card: 1 - the union of their intervals / the window (chip_smoke.py phase
11's arithmetic), in %."""

from rtbench import trace

SOURCE, UNIT = "device_trace", "%"
LAYER = "Device"
MOVES = "frame_ms"


def read(run):
    if run.traced is None:
        return None
    lo, hi = run.traced
    busy = sum(b - a for a, b in trace.busy_intervals(run.device_events, lo,
                                                       hi))
    return 100.0 * (1.0 - busy / (hi - lo))
