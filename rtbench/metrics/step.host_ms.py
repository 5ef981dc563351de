"""Host ms of a ``Renderer.step`` call in the window (the block write and
the graph's replay being enqueued), the mean: the benchmark's span around
each call."""

SOURCE, UNIT = "program_span", "ms"
LAYER = "Renderer and compiled step"
MOVES = "frame_ms"


def read(run):
    spans = run.spans.durations("step")
    return 1000.0 * sum(spans) / len(spans) if spans else None
