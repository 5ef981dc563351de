"""Seconds of the sub-block build: the program's span ``scene.subblock``
(``build_subblock_parts`` inside ``Scene.fields``), whether the caps
refused it or not, the last that ended before the traced window opened."""

from rtbench import program

SOURCE, UNIT = "program_span", "s"
LAYER = "Scene authoring"
MOVES = "setup_s"


def read(run):
    return program.seconds_before_window(run, "scene.subblock")
