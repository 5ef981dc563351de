"""Device ms a frame of the App's display path in the traced window: the
8-bit conversion kernel (``to_uint8`` in its name, ``csrc/to_uint8.cu``)
and the copies to the host (the ``readback`` group, which in the App's
loop holds only the display's copy).  None without a trace or frames, or
where the window ran no conversion kernel."""

from rtbench import trace

SOURCE, UNIT = "device_trace", "ms"
LAYER = "App display"
MOVES = "frame_ms"


def read(run):
    if run.traced is None or not run.n_frames:
        return None
    lo, hi = run.traced
    us, kernels = 0.0, 0
    for name, a, b in run.device_events:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if "to_uint8" in name:
            kernels += 1
            us += b - a
        elif trace.group(name) == "readback":
            us += b - a
    return us / 1e3 / run.n_frames if kernels else None
