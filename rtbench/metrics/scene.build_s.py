"""Seconds of the scene's authoring: the benchmark's span around
``Scene(...)`` (the BVH), ``Scene.fields()`` (the tables) and
``Scene.send()`` (packing and upload)."""

SOURCE, UNIT = "program_span", "s"
LAYER = "Scene authoring"
MOVES = "setup_s"


def read(run):
    spans = run.spans.durations("scene")
    return spans[0] if spans else None
