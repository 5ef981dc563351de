"""Camera model: yaw/pitch basis in NumPy, angle-linear projection in torch.

The reference computes an orthonormal (right, forward, up) basis from yaw and
pitch in degrees (reference: main.py:211-237) and generates rays with an
**angle-linear** projection: the ray direction is ``camRight * (dirStartX +
u * xStep) + camUp * (dirStartY + v * yStep) + camForward``, normalized,
with ``fov = radians(90)`` (main.py:166-170, fragment.glsl:368-374).

UV conventions follow GL: uv = ((px + 0.5) / W, (py + 0.5) / H) with py = 0
the *bottom* row.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Camera(NamedTuple):
    """Camera basis as (3,) float32 NumPy arrays.  The ray math reads each
    component as a scalar, so the camera lives on the host whatever device
    the rays are on."""

    pos: np.ndarray
    right: np.ndarray
    up: np.ndarray
    forward: np.ndarray


def camera_basis(cam_dir) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(right, forward, up) from (yaw_deg, pitch_deg) (main.py:211-237)."""
    yaw = math.radians(float(cam_dir[0]))
    pitch = math.radians(float(cam_dir[1]))

    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)

    forward = np.array([sy * cp, sp, cy * cp], dtype=np.float32)
    forward /= np.linalg.norm(forward)

    world_up = np.array([0.0, 1.0, 0.0], dtype=np.float32)
    right = np.cross(world_up, forward)
    right /= np.linalg.norm(right)
    up = np.cross(forward, right)
    up /= np.linalg.norm(up)
    return right, forward, up


def make_camera(pos, cam_dir) -> Camera:
    """Build a Camera from position and (yaw, pitch) degrees."""
    right, forward, up = camera_basis(cam_dir)
    return Camera(pos=np.asarray(pos, dtype=np.float32), right=right, up=up,
                  forward=forward)


def angle_linear_constants(width: int, height: int,
                           fov: float = math.radians(90.0),
                           aspect: float | None = None) -> tuple:
    """(dir_start_x, dir_start_y, x_step, y_step) of the angle-linear
    projection, each rounded to float32, as the JAX package's weakly typed
    Python scalars become float32 in its float32 arithmetic."""
    if aspect is None:
        aspect = width / height
    return (float(np.float32(-fov / 2.0 * aspect)),
            float(np.float32(-fov / 2.0)), float(np.float32(fov * aspect)),
            float(np.float32(fov)))


def ray_dirs(camera: Camera, u: torch.Tensor, v: torch.Tensor, width: int,
             height: int, fov: float = math.radians(90.0),
             aspect: float | None = None) -> torch.Tensor:
    """The (R, 3) form of :func:`ray_dirs_soa`
    (``opengl_raytracer_tpu/ops/camera.py:65``).  The reference computes
    ``aspect`` from the display size (main.py:137); None means the render
    aspect, width / height."""
    return torch.stack(ray_dirs_soa(camera, u, v, width, height, fov=fov,
                                    aspect=aspect), dim=-1)


def ray_dirs_soa(camera: Camera, u: torch.Tensor, v: torch.Tensor,
                 width: int, height: int,
                 fov: float = math.radians(90.0),
                 aspect: float | None = None) -> tuple:
    """Angle-linear primary ray directions for (R,) uv tensors, as a
    3-tuple of (R,) float32 columns (fragment.glsl:368-374)."""
    dir_start_x, dir_start_y, x_step, y_step = angle_linear_constants(
        width, height, fov, aspect)

    dx = dir_start_x + u * x_step
    dy = dir_start_y + v * y_step
    d = tuple(
        float(camera.right[a]) * dx + float(camera.up[a]) * dy
        + float(camera.forward[a])
        for a in range(3)
    )
    d_len = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return tuple(d[a] / d_len for a in range(3))


def pixel_uv(px: torch.Tensor, py: torch.Tensor, width: int, height: int):
    """GL-convention uv at pixel centers; py = 0 is the bottom row."""
    u = (px.to(torch.float32) + 0.5) / width
    v = (py.to(torch.float32) + 0.5) / height
    return u, v
