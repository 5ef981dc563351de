"""Device ms a frame of everything on the card but the traversals, their
epilogues, K2 and copies to the host: G1, G2, the sort, G3 (index
pass, gather, restore), G6, the block write, copies and sets, and the
other torch kernels."""

SOURCE, UNIT = "device_trace", "ms"
LAYER = "Integrator and glue"
MOVES = "frame_ms"
NOT_MINE = {"K1", "G4 K1 epilogue", "G5 K3 prologue/epilogue", "K3", "K2",
            "G7 bvh walk", "G8 brute sweep", "G9 packet walk", "readback"}


def read(run):
    if run.traced is None:
        return None
    groups = run.group_ms_per_frame()
    return sum(ms for g, ms in groups.items() if g not in NOT_MINE)
