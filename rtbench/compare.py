"""The comparison that decides ``correct``.

An answer is what the timed path produced for a sample of pixels: the
linear colour of a finished render (``accum``), with the camera and the
number of frames it holds.  Answers of one camera and frame count share
one reference: the mean colour over those frames of the plain reference
(``reference/pathtrace.py``), computed here after the window.  A pixel is
wrong where any channel lies more than the cell's ``tau`` from the
reference, or is not finite.  The compared number is the share of wrong
pixels.
"""

from __future__ import annotations

import numpy as np


def keys(answers: list) -> list:
    """The (camera position, yaw/pitch, frames) of the answers, each
    once."""
    out = sorted({a["key"] for a in answers})
    if not out:
        raise RuntimeError("the window finished no answer to compare")
    return out


def references(keys: list, objs: list, render: dict, pixels, device,
               dtype=None, live=None) -> dict:
    """The reference's mean colour (K, 3) of each group, in ``dtype``
    (float32 when None); ``live`` gains its rays alive a segment
    (``pathtrace.trace``)."""
    import torch

    from rtbench import scenes
    from rtbench.reference import pathtrace

    dtype = torch.float32 if dtype is None else dtype
    tree = pathtrace.Tree(scenes.flatten(objs), dtype, device)
    return {k: pathtrace.render_mean(tree, pixels, k[2], render["width"],
                                     render["height"], k[0], k[1], render,
                                     dtype, device, live=live)
            for k in keys}


def wrong(values: np.ndarray, ref: np.ndarray, check: dict) -> np.ndarray:
    """Per pixel: does the answer lie beyond the tolerance?"""
    gap = np.abs(values.astype(np.float64) - ref)
    return ~(gap <= check["tau"]).all(axis=1)


def score(answers: list, refs: dict, check: dict) -> dict:
    """{compared number: (value, limit)} of the answers."""
    bad = total = 0
    for a in answers:
        w = wrong(a["values"], refs[a["key"]], check)
        bad += int(w.sum())
        total += w.size
    return {"bad_pixels_pct": (100.0 * bad / total,
                               check["limits"]["bad_pixels_pct"])}


def check(answers: list, objs: list, render: dict, check: dict, pixels,
          device, live=None) -> dict:
    return score(answers, references(keys(answers), objs, render, pixels,
                                     device, live=live), check)


def control(answers: list, objs: list, render: dict, check: dict, pixels,
            device, dtype) -> dict:
    """The control: the reference computed in ``dtype`` put in the
    program's place, each answer replaced by it, then scored as
    :func:`check` scores the program."""
    low = references(keys(answers), objs, render, pixels, device, dtype)
    fake = [dict(a, values=low[a["key"]]) for a in answers]
    return score(fake, references(keys(answers), objs, render, pixels,
                                  device), check)
