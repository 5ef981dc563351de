"""Procedural axis-aligned box primitive.

API-compatible with the reference ``Rect`` (reference: object.py:241-307):
6 faces x 2 triangles = 36 vertices with per-face normals and corner UVs,
then the same CPU world bake as ``Mesh``.
"""

from __future__ import annotations

import numpy as np

from opengl_raytracer_torch.models.transforms import bake_world


def make_cube_vertices(size) -> np.ndarray:
    """(36, 8) float32 [px,py,pz, nx,ny,nz, u,v] rows; two triangles per
    face, corner order (0,1,2) and (0,2,3) (reference: object.py:262-307)."""
    sx, sy, sz = (float(size[0]), float(size[1]), float(size[2]))
    hx, hy, hz = sx / 2.0, sy / 2.0, sz / 2.0

    faces = [
        # +Z front
        ((-hx, -hy, hz), (hx, -hy, hz), (hx, hy, hz), (-hx, hy, hz), (0.0, 0.0, 1.0)),
        # -Z back
        ((hx, -hy, -hz), (-hx, -hy, -hz), (-hx, hy, -hz), (hx, hy, -hz), (0.0, 0.0, -1.0)),
        # +Y top
        ((-hx, hy, hz), (hx, hy, hz), (hx, hy, -hz), (-hx, hy, -hz), (0.0, 1.0, 0.0)),
        # -Y bottom
        ((-hx, -hy, -hz), (hx, -hy, -hz), (hx, -hy, hz), (-hx, -hy, hz), (0.0, -1.0, 0.0)),
        # +X right
        ((hx, -hy, hz), (hx, -hy, -hz), (hx, hy, -hz), (hx, hy, hz), (1.0, 0.0, 0.0)),
        # -X left
        ((-hx, -hy, -hz), (-hx, -hy, hz), (-hx, hy, hz), (-hx, hy, -hz), (-1.0, 0.0, 0.0)),
    ]
    uv0, uv1, uv2, uv3 = (0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)

    verts = []
    for p0, p1, p2, p3, normal in faces:
        nx, ny, nz = normal
        verts.append((*p0, nx, ny, nz, *uv0))
        verts.append((*p1, nx, ny, nz, *uv1))
        verts.append((*p2, nx, ny, nz, *uv2))
        verts.append((*p0, nx, ny, nz, *uv0))
        verts.append((*p2, nx, ny, nz, *uv2))
        verts.append((*p3, nx, ny, nz, *uv3))
    return np.array(verts, dtype=np.float32)


class Rect:
    def __init__(
        self,
        size,
        pos,
        eulers,
        color=(0, 0, 0),
        emission_color=(0, 0, 0),
        emission=0.0,
        roughness=0.0,
        scale=1.0,
    ):
        self.position = np.array(pos, dtype=np.float32)
        self.eulers = np.array(eulers, dtype=np.float32)
        self.scale = np.array([scale, scale, scale], dtype=np.float32)

        verts = make_cube_vertices(size).reshape(-1, 8).astype(np.float32)
        self.pos = verts[:, 0:3]
        self.normals = verts[:, 3:6]
        self.uvs = verts[:, 6:8].copy()

        self.pos, self.normals = bake_world(
            self.pos, self.normals, self.position, self.eulers, self.scale
        )

        self.color = color
        self.emission_color = np.array(emission_color)
        self.emission = emission
        self.roughness = roughness
