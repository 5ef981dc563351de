"""Console progress policy for slow host-side phases (OBJ parse, BVH build).

A copy of ``opengl_raytracer_tpu/utils/progress.py``.  The reference prints
carriage-return progress bars unconditionally during its OBJ parse and BVH
build (loadObject.pyx:20-21, boundingBoxes.pyx:46,64-65).  Here the default
is *auto*: progress prints when stdout is a terminal and stays quiet
otherwise.  An explicit ``True``/``False`` (``Scene(verbose=True)`` from the
app and the CLI) and the ``OGLRT_PROGRESS`` environment variable override
the auto rule.
"""

from __future__ import annotations

import os
import sys


def progress_enabled(explicit: bool | None = None) -> bool:
    """Resolve a tri-state progress flag: explicit > env > tty auto."""
    if explicit is not None:
        return bool(explicit)
    env = os.environ.get("OGLRT_PROGRESS")
    if env is not None:
        return env.strip().lower() not in ("", "0", "false", "no")
    try:
        return sys.stdout.isatty()
    except (AttributeError, ValueError):
        return False
