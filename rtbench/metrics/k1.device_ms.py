"""Device ms a frame of the K1 traversal: K1, its part epilogue G4 and
its entry t (G5)."""

SOURCE, UNIT = "device_trace", "ms"
LAYER = "K1 traversal"
MOVES = "frame_ms"


def read(run):
    if run.traced is None:
        return None
    groups = run.group_ms_per_frame()
    if "K1" not in groups:
        return None
    return (groups["K1"] + groups.get("G4 K1 epilogue", 0.0)
            + groups.get("G5 K3 prologue/epilogue", 0.0))
