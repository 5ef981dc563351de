"""Host ms a frame in the program's span ``app.present`` (``App.frame``:
the wait for the copy of the previous sweep's 8-bit frame to the host,
then the display sink until it returns), over the traced window's frames.
None without a trace or frames, or where the window holds no such span
(a program whose App keeps none)."""

from rtbench import program

SOURCE, UNIT = "program_span", "ms"
LAYER = "App display"
MOVES = "frame_ms"


def read(run):
    got = program.spans()
    if run.traced is None or not run.n_frames or got is None:
        return None
    lo, hi = run.traced
    ns = [s.end_ns - s.start_ns for s in got
          if s.name == "app.present" and lo <= s.start_ns / 1e3 < hi]
    return sum(ns) / 1e6 / run.n_frames if ns else None
