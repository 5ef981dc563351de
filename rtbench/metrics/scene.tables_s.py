"""Seconds of the scene's tables: the self time of the program's span
``scene.fields`` (the permuted triangles, the octet tables, the wide
collapse and the shading rows), which is its duration less that of its
child ``scene.subblock``; the last that ended before the traced window
opened."""

from rtbench import program

SOURCE, UNIT = "program_span", "s"
LAYER = "Scene authoring"
MOVES = "setup_s"


def read(run):
    fields = program.last_before_window(run, "scene.fields")
    if fields is None:
        return None
    child = sum(s.end_ns - s.start_ns for s in program.spans()
                if s.name == "scene.subblock" and s.parent is fields)
    return (fields.end_ns - fields.start_ns - child) / 1e9
