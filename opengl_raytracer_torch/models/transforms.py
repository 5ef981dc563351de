"""CPU-side world-space baking for scene objects.

The reference bakes every object's transform on the host before upload: the
model matrix is ``R @ S`` (scale, then rotate) plus a translation, and normals
go through the inverse-transpose with renormalization and a zero-norm guard
(reference: object.py:43-108; duplicated verbatim at object.py:309-373 — here
it lives once).  Euler angles are XYZ order, degrees.
"""

from __future__ import annotations

import numpy as np


def rotation_matrix_from_euler(rx: float, ry: float, rz: float, order: str = "XYZ") -> np.ndarray:
    """3x3 rotation from Euler radians; `order` lists application order,
    first-applied first (reference: object.py:56-79)."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)

    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], dtype=np.float32)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=np.float32)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], dtype=np.float32)

    mats = {"X": Rx, "Y": Ry, "Z": Rz}
    R = np.eye(3, dtype=np.float32)
    for axis in reversed(order):
        R = mats[axis] @ R
    return R


def model_and_normal_matrices(position, euler_deg, scale=(1.0, 1.0, 1.0), order: str = "XYZ"):
    """Return (4x4 model matrix, 3x3 normal matrix).

    Normal matrix = transpose(inverse(RS)); falls back to the bare rotation
    if RS is singular (reference: object.py:81-108).
    """
    rx, ry, rz = np.deg2rad(np.asarray(euler_deg, dtype=np.float64))
    sx, sy, sz = scale

    R3 = rotation_matrix_from_euler(rx, ry, rz, order)
    S3 = np.diag([sx, sy, sz]).astype(np.float32)
    RS3 = R3 @ S3

    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = RS3
    M[:3, 3] = np.asarray(position, dtype=np.float32)

    try:
        normal_mat = np.linalg.inv(M[:3, :3]).T.astype(np.float32)
    except np.linalg.LinAlgError:
        normal_mat = R3.astype(np.float32)
    return M, normal_mat


def bake_world(pos: np.ndarray, normals: np.ndarray, position, euler_deg, scale):
    """Transform object-space positions/normals to world space.

    Positions: ``(R S) p + t``.  Normals: normal-matrix transform +
    renormalize, guarding zero-length rows (reference: object.py:43-54).
    """
    model_mat4, normal_mat3 = model_and_normal_matrices(position, euler_deg, scale)
    RS3 = model_mat4[:3, :3]
    translation = model_mat4[:3, 3]
    world_pos = pos @ RS3.T + translation
    world_normals = normals @ normal_mat3.T
    norms = np.linalg.norm(world_normals, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    world_normals = world_normals / norms
    return world_pos.astype(np.float32), world_normals.astype(np.float32)
