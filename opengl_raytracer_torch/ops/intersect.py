"""Ray-triangle intersection and hit resolution.

* :func:`mt_single` — the reference's Möller–Trumbore test in its plane-
  determinant form (fragment.glsl:106-177) with ``EPS = 1e-6``
  parallel/self-hit rejection, on per-ray gathered triangles.  It is the
  triangle test of the traversal kernel's plain version.
* :func:`finalize_hit_soa` — the nearest-hit record resolved into the
  shader's Hit fields (fragment.glsl:146-176); with the integrator's
  scatter and state update it forms the shade kernel's plain version.

Vec3 quantities travel as 3-tuples of (R,) columns, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

EPS = float(np.float32(1e-6))
BIG = float(np.float32(1e30))
TINY = float(np.float32(1e-30))


class Nearest(NamedTuple):
    """Nearest hit per ray: distance, triangle id (scene order), the
    triangle's barycentrics, and the winner's global leaf slot (an index
    into ``SceneData.sh_slot``)."""

    t: torch.Tensor  # (R,) float32, BIG on a miss
    tri: torch.Tensor  # (R,) int32
    u: torch.Tensor  # (R,) float32
    v: torch.Tensor  # (R,) float32
    slot: torch.Tensor  # (R,) int32


def mt_single(o3, d3, v0, e1, e2, face):
    """Möller–Trumbore for per-ray triangle data.  ``o3``/``d3`` are
    3-tuples of (R,) columns; v0/e1/e2/face are 3-tuples of (R,) columns
    too (the triangle each ray is tested against).

    Returns (valid, t, u, v) with the reference's rejection rules
    (fragment.glsl:110-143), in the JAX kernel's operation order
    (``opengl_raytracer_tpu/ops/subblock_traversal.py:546-559``).
    """
    det = d3[0] * face[0] + d3[1] * face[1] + d3[2] * face[2]
    inv_det = 1.0 / det
    rx, ry, rz = o3[0] - v0[0], o3[1] - v0[1], o3[2] - v0[2]
    t = -(rx * face[0] + ry * face[1] + rz * face[2]) * inv_det
    px = ry * d3[2] - rz * d3[1]
    py = rz * d3[0] - rx * d3[2]
    pz = rx * d3[1] - ry * d3[0]
    u = -(e2[0] * px + e2[1] * py + e2[2] * pz) * inv_det
    v = (e1[0] * px + e1[1] * py + e1[2] * pz) * inv_det
    valid = ((det.abs() >= EPS) & (t > EPS) & (u >= 0.0) & (v >= 0.0)
             & ((u + v) <= 1.0))
    return valid, t, u, v


class HitSoA(NamedTuple):
    """SoA nearest-hit record (the shader's ``Hit`` struct,
    fragment.glsl:68-81): vec3 fields are 3-tuples of (R,) columns."""

    did_hit: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,)
    point: tuple  # 3 x (R,)
    normal: tuple  # 3 x (R,)
    color: tuple  # 3 x (R,)
    emission: torch.Tensor  # (R,)
    emission_color: tuple  # 3 x (R,)
    roughness: torch.Tensor  # (R,)


def _norm3(x, y, z):
    return torch.sqrt(x * x + y * y + z * z)


def finalize_hit_soa(scene, o3, d3, nearest: Nearest) -> HitSoA:
    """Hit point, smooth barycentric normal with degenerate fallback to the
    geometric normal, flip toward the ray, and the material fetch
    (fragment.glsl:146-176).  Materials come from the slot-order table
    ``scene.sh_slot``, gathered by the traversal's winning slot."""
    did_hit = nearest.t < BIG
    point = tuple(o3[a] + d3[a] * nearest.t for a in range(3))

    S = scene.sh_slot.shape[0]
    abc = scene.sh_slot[nearest.slot.long().clamp(0, S - 1)].T
    n0 = (abc[0], abc[1], abc[2])
    n1 = (abc[3], abc[4], abc[5])
    n2 = (abc[8], abc[9], abc[10])
    face = (abc[11], abc[12], abc[13])

    u, v = nearest.u, nearest.v
    w = 1.0 - u - v
    raw = tuple(n0[a] * w + n1[a] * u + n2[a] * v for a in range(3))
    raw_len = _norm3(*raw)
    face_len = _norm3(*face)
    # fragment.glsl:155-160 — normalize, falling back to the geometric
    # normal when interpolation degenerates (guarded div instead of NaN).
    ok_len = raw_len > float(np.float32(1e-20))
    den_raw = raw_len.clamp_min(TINY)
    den_face = face_len.clamp_min(TINY)
    normal = tuple(torch.where(ok_len, raw[a] / den_raw, face[a] / den_face)
                   for a in range(3))
    # Flip the normal against the incoming ray (fragment.glsl:163-165).
    flip = (d3[0] * normal[0] + d3[1] * normal[1] + d3[2] * normal[2]) > 0.0
    normal = tuple(torch.where(flip, -normal[a], normal[a]) for a in range(3))

    return HitSoA(
        did_hit=did_hit,
        t=nearest.t,
        point=point,
        normal=normal,
        color=(abc[16], abc[17], abc[18]),
        emission=abc[6],
        emission_color=(abc[19], abc[20], abc[21]),
        roughness=abc[7],
    )
