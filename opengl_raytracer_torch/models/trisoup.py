"""Raw-triangle scene object: programmatic geometry without an OBJ file.

The reference has no direct-geometry API (everything is Mesh-from-OBJ or
Rect, object.py:8,241); this small addition makes tests and procedural
scenes first-class.  Exposes the same attribute surface Scene consumes
(scene.py:25-37): .pos/.normals/.uvs plus flat material fields.
"""

from __future__ import annotations

import numpy as np


class Triangles:
    def __init__(
        self,
        vertices,
        normals=None,
        color=(0, 0, 0),
        emission_color=(0, 0, 0),
        emission=0.0,
        roughness=0.0,
    ):
        """vertices: (T, 3, 3) or (3T, 3) float array of triangle corners.
        normals: matching per-vertex normals; default = per-face geometric
        normals."""
        v = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
        if v.shape[0] % 3:
            raise ValueError("vertex count must be a multiple of 3")
        self.pos = v

        if normals is None:
            tri = v.reshape(-1, 3, 3)
            face_n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
            ln = np.linalg.norm(face_n, axis=1, keepdims=True)
            ln[ln == 0] = 1.0
            face_n = face_n / ln
            normals = np.repeat(face_n, 3, axis=0)
        self.normals = np.asarray(normals, dtype=np.float32).reshape(-1, 3)

        self.uvs = np.zeros((v.shape[0], 2), dtype=np.float32)
        self.color = color
        self.emission_color = emission_color
        self.emission = emission
        self.roughness = roughness
