"""Wavefront OBJ parsing (a copy of ``opengl_raytracer_tpu/models/obj.py``).

Semantics of the reference's Cython parser (reference:
loadObject.pyx:3-131):

* streams ``v`` / ``vt`` / ``vn`` pools;
* triangulates arbitrary polygons by fan: triangle i = (face[0],
  face[1+i], face[2+i]) (loadObject.pyx:53-67);
* resolves the face-index forms ``v/t/n``, ``v//n``, ``v/t/``, ``v/t``
  and ``v`` with 1-based indices; a missing uv defaults to (0, 0) and a
  missing normal to (0, 0, 1) (loadObject.pyx:69-108); a token of four or
  more fields takes both defaults;
* indexes the pools as ``pool[int(tok) - 1]``, so ``0`` and negative
  tokens wrap around Python-style (``0`` is the last entry), not as the
  OBJ specification's relative indices (loadObject.pyx:82);
* the V texture coordinate is flipped: stored uv = (u, 1 - v)
  (loadObject.pyx:109);
* positions take the *last three* fields of a ``v`` line, so ``v x y z w``
  is handled (loadObject.pyx:113-118).

Output is a single ``(N, 8) float32`` array of ``[px,py,pz, nx,ny,nz, u,v]``
rows, three rows per triangle (object.py:29-33).  :func:`load_obj_py` is the
Python version; the C++ one (``native/objparser.cpp``, a copy of the JAX
package's, bound by ``native/loader.py``) is preferred by :func:`load_obj`.
"""

from __future__ import annotations

import numpy as np

from opengl_raytracer_torch.utils.progress import progress_enabled

last_parser: str | None = None  # "native" or "python": the last load_obj's


def load_obj_py(file_path: str, progress: bool | None = None) -> np.ndarray:
    """Parse an OBJ file to an (N, 8) float32 vertex array (pure Python).

    With progress enabled, prints the reference's carriage-return percent
    bar every ``max(lines // 100, 10)`` lines plus a closing newline
    (loadObject.pyx:14,20-21,48).  An index past a pool raises IndexError,
    as in the reference."""
    show = progress_enabled(progress)
    vp: list[list[float]] = []
    vt: list[list[float]] = []
    vn: list[list[float]] = []
    out: list[float] = []

    with open(file_path, "r") as f:
        lines = f.readlines()
    step = max(len(lines) // 100, 10)
    for i, line in enumerate(lines, start=1):
        if show and i % step == 0:
            print(f"\r{round(i / len(lines) * 100, 2)} %", end="", flush=True)
        words = line.split()
        if not words:
            continue
        tag = words[0]
        if tag == "v":
            vp.append([float(words[-3]), float(words[-2]), float(words[-1])])
        elif tag == "vt":
            vt.append([float(words[1]), float(words[2])])
        elif tag == "vn":
            vn.append([float(words[1]), float(words[2]), float(words[3])])
        elif tag == "f":
            _read_faces(words[1:], vp, vn, vt, out)
    if show:
        print("")

    arr = np.asarray(out, dtype=np.float32)
    return arr.reshape(-1, 8)


def _read_faces(faces, vp, vn, vt, out) -> None:
    """Fan triangulation (loadObject.pyx:53-67)."""
    for i in range(len(faces) - 2):
        _get_vertex(faces[0], vp, vn, vt, out)
        _get_vertex(faces[1 + i], vp, vn, vt, out)
        _get_vertex(faces[2 + i], vp, vn, vt, out)


def _get_vertex(face: str, vp, vn, vt, out) -> None:
    """Resolve one face corner to [pos, normal, u, 1-v] (loadObject.pyx:69-111)."""
    f = face.split("/")
    v = vp[int(f[0]) - 1]
    if len(f) == 3:
        t = vt[int(f[1]) - 1] if f[1] != "" else [0.0, 0.0]
        n = vn[int(f[2]) - 1] if f[2] != "" else [0.0, 0.0, 1.0]
    elif len(f) == 2:
        t = vt[int(f[1]) - 1]
        n = [0.0, 0.0, 1.0]
    else:
        t = [0.0, 0.0]
        n = [0.0, 0.0, 1.0]
    out.extend(v)
    out.extend(n)
    out.append(t[0])
    out.append(1.0 - t[1])


def load_obj(file_path: str, progress: bool | None = None) -> np.ndarray:
    """Parse an OBJ file with the native C++ parser when it builds, else
    with :func:`load_obj_py`; ``last_parser`` records which one ran."""
    global last_parser
    show = progress_enabled(progress)
    from opengl_raytracer_torch.native import loader

    if loader.get_lib() is not None:
        try:
            arr = loader.load_obj_native(file_path, progress=show)
            last_parser = "native"
            return arr
        except OSError:
            pass  # the Python parser raises the reference's error
    last_parser = "python"
    return load_obj_py(file_path, progress=show)
