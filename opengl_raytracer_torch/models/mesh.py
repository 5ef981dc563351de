"""Triangle-mesh scene object loaded from a Wavefront OBJ (a copy of
``opengl_raytracer_tpu/models/mesh.py``).

API of the reference ``Mesh`` (reference: object.py:8-41): ``Mesh(pos,
eulers, dirPath, color, emission_color, emission, roughness, scale)``.  The
object's ``.pos`` / ``.normals`` / ``.uvs`` are world-space float32 arrays
after the CPU bake, plus flat material attributes, which is what ``Scene``
flattens (scene.py:25-37).

``dirPath`` may be a directory holding one ``.obj``, a path to an ``.obj``
file, or a bare name searched along ``OGLRT_MODELS_PATH`` (a list of
asset roots; default ``./models``), broader than the reference's
hard-coded ``models/<dir>`` join (object.py:9).
"""

from __future__ import annotations

import os

import numpy as np

from opengl_raytracer_torch.models.obj import load_obj
from opengl_raytracer_torch.models.transforms import bake_world

_DEFAULT_SEARCH = ["models"]


def resolve_obj_path(dir_path: str) -> str:
    """Find the .obj file for a model name, directory, or file path; the
    FileNotFoundError names every path searched."""
    candidates = []
    if os.path.isabs(dir_path) or os.path.exists(dir_path):
        candidates.append(dir_path)
    env = os.environ.get("OGLRT_MODELS_PATH")
    roots = env.split(os.pathsep) if env else _DEFAULT_SEARCH
    candidates.extend(os.path.join(root, dir_path) for root in roots)

    for cand in candidates:
        if os.path.isfile(cand) and cand.endswith(".obj"):
            return cand
        if os.path.isdir(cand):
            for fname in sorted(os.listdir(cand)):
                if fname.endswith(".obj"):
                    return os.path.join(cand, fname)
    raise FileNotFoundError(
        f"No .obj found for {dir_path!r} (searched {candidates}); "
        f"set OGLRT_MODELS_PATH to add asset roots"
    )


class Mesh:
    def __init__(
        self,
        pos,
        eulers,
        dirPath,
        color=(0, 0, 0),
        emission_color=(0, 0, 0),
        emission=0.0,
        roughness=0.0,
        scale=1.0,
    ):
        self.position = np.array(pos, dtype=np.float32)
        self.eulers = np.array(eulers, dtype=np.float32)
        self.scale = np.array([scale, scale, scale], dtype=np.float32)

        verts = load_obj(resolve_obj_path(dirPath)).reshape(-1, 8).astype(
            np.float32)
        self.uvs = verts[:, 6:8].copy()
        self.pos, self.normals = bake_world(
            verts[:, 0:3], verts[:, 3:6], self.position, self.eulers,
            self.scale)

        self.color = color
        self.emission_color = emission_color
        self.emission = emission
        self.roughness = roughness
