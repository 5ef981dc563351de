"""Device ms a frame of G4, K1's part epilogue: one launch a part a
segment, each resolving its part's hits and keeping the nearer of them
and the earlier parts'."""

SOURCE, UNIT = "device_trace", "ms"
LAYER = "K1 part chain"
MOVES = "frame_ms"


def read(run):
    if run.traced is None:
        return None
    return run.group_ms_per_frame().get("G4 K1 epilogue")
