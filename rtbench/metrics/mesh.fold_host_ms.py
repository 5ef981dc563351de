"""Host ms a mesh step spends in the program's span ``mesh.fold``
(``parallel/sharding.py:sharded_tile_step``: the sums over sp, the copies
between devices and the folds into the slices, all issued eagerly), the
mean over the traced window's steps.  None without a trace, or where the
window holds no such span (a program that keeps none)."""

from rtbench import program

SOURCE, UNIT = "program_span", "ms"
LAYER = "Mesh step"
MOVES = "frame_ms"


def read(run):
    got = program.spans()
    if run.traced is None or got is None:
        return None
    lo, hi = run.traced
    ns = [s.end_ns - s.start_ns for s in got
          if s.name == "mesh.fold" and lo <= s.start_ns / 1e3 < hi]
    return sum(ns) / len(ns) / 1e6 if ns else None
