"""Seconds of the scene's BVH build: the program's span ``scene.bvh``
(``Scene(...)``'s ``build_bvh``; its ``builder`` says native or NumPy),
the last that ended before the traced window opened."""

from rtbench import program

SOURCE, UNIT = "program_span", "s"
LAYER = "Scene authoring"
MOVES = "setup_s"


def read(run):
    return program.seconds_before_window(run, "scene.bvh")
