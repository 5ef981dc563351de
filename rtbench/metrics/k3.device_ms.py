"""Device ms a frame of the K3 traversal: K3 and its prologue and
epilogue (G5)."""

SOURCE, UNIT = "device_trace", "ms"
LAYER = "K3 traversal"
MOVES = "frame_ms"


def read(run):
    if run.traced is None:
        return None
    groups = run.group_ms_per_frame()
    if "K3" not in groups:
        return None
    return groups["K3"] + groups.get("G5 K3 prologue/epilogue", 0.0)
