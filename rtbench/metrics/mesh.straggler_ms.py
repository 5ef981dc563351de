"""Device ms a mesh step waits on its slowest card: over the traced
window's steps, the mean of the largest owner card's device ms less the
mean card's.  A card's device ms a step is the program's device span
``mesh.card`` (``parallel/sharding.py:sharded_tile_step``: CUDA events on
the card before its shard's first launch and after its folds; ``args``
``card``, ``device_ms``).  Steps with fewer than two cards' spans are left
out.  None without a trace, or where the window holds no such step (a
program that keeps no card spans, or a mesh on the CPU)."""

from rtbench import program

SOURCE, UNIT = "program_span", "ms"
LAYER = "Mesh step"
MOVES = "frame_ms"


def read(run):
    got = program.spans()
    if run.traced is None or got is None:
        return None
    lo, hi = run.traced
    steps: dict = {}
    for s in got:
        if s.name == "mesh.card" and lo <= s.start_ns / 1e3 < hi:
            steps.setdefault(s.step, []).append(s.args["device_ms"])
    gaps = [max(ms) - sum(ms) / len(ms) for ms in steps.values()
            if len(ms) > 1]
    return sum(gaps) / len(gaps) if gaps else None
