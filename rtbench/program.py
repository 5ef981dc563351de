"""The program's own spans, for the metric readers.

The port keeps spans where its work happens
(``opengl_raytracer_torch/utils/profiling.py``), stamped with
``time.time_ns()``, the clock of ``torch.profiler``'s events: divided by
1e3 a span lies on the trace's microseconds beside ``run.device_events``.
The program opens no profiler range, so its spans never reach
``trace.read``'s device events.  A program that keeps no spans gives None,
and so does every reader here.
"""

from __future__ import annotations

from rtbench import trace

# a window that holds one of these measured a rebuild, not the steady state
REBUILDS = ("step.capture", "kernels.build", "native.build")


def spans() -> list | None:
    """The program's recorded spans, or None where it keeps none."""
    from opengl_raytracer_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def last_before_window(run, name: str):
    """The last ``name`` span that ended before the traced window opened,
    or None."""
    got = spans()
    if run.traced is None or got is None:
        return None
    lo = run.traced[0] * 1e3
    found = [s for s in got if s.name == name and s.end_ns <= lo]
    return found[-1] if found else None


def seconds_before_window(run, name: str) -> float | None:
    """Seconds of :func:`last_before_window`'s span."""
    s = last_before_window(run, name)
    return None if s is None else (s.end_ns - s.start_ns) / 1e9


def idle_ms(run, name: str) -> float | None:
    """Ms a frame in the traced window during which no device event ran
    while the host was inside the program's leaf span ``name``: the
    window's idle gaps (``trace.busy_intervals``, ``trace.idle_gaps``)
    split by the program's leaf spans, over ``run.n_frames``.  None
    without a trace or frames, where the window holds no ``name`` span, or
    where it holds one of :data:`REBUILDS`."""
    got = spans()
    if run.traced is None or not run.n_frames or got is None:
        return None
    lo, hi = run.traced
    inside = [s for s in got if s.end_ns / 1e3 > lo and s.start_ns / 1e3 < hi]
    names = {s.name for s in inside}
    if name not in names or names & set(REBUILDS):
        return None
    parents = {id(s.parent) for s in inside if s.parent is not None}
    leaves = sorted(((s.name, s.start_ns / 1e3, s.end_ns / 1e3)
                     for s in inside if id(s) not in parents),
                    key=lambda h: h[1])
    # a window with no device event is idle throughout: an empty busy
    # interval at its opening lets idle_gaps split it by span
    busy = trace.busy_intervals(run.device_events, lo, hi) or [(lo, lo)]
    gaps = trace.idle_gaps(busy, leaves, lo, hi)
    return gaps.get(name, 0.0) * 1e3 / run.n_frames
