"""Seconds of the scene's upload: the program's span ``scene.upload``
(``scene_from_numpy``: K1's and K3's packing and the copies to the card,
ended once they finished), the last that ended before the traced window
opened."""

from rtbench import program

SOURCE, UNIT = "program_span", "s"
LAYER = "Scene authoring"
MOVES = "setup_s"


def read(run):
    return program.seconds_before_window(run, "scene.upload")
