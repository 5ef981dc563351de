"""Ray-triangle and ray-box intersection, brute force, and hit resolution.

* :func:`mt_single` — the reference's Möller–Trumbore test in its plane-
  determinant form (fragment.glsl:106-177) with ``EPS = 1e-6``
  parallel/self-hit rejection, on per-ray gathered triangles.  It is the
  triangle test of the traversals' plain versions.
* :func:`slab_test` — the slab AABB test (fragment.glsl:181-204).
* :func:`raycast_brute` — every ray against every triangle, in the JAX
  package's matmul form (``opengl_raytracer_tpu/ops/intersect.py:120-205``):
  ``torch.matmul`` in full float32, chunks of 2048 triangles, the lowest
  index winning a tie within a chunk and a strict ``<`` across chunks.
* :func:`finalize_hit_soa` — the nearest-hit record resolved into the
  shader's Hit fields (fragment.glsl:146-176); with the integrator's
  scatter and state update it forms the shade kernel's plain version.

Vec3 quantities travel as 3-tuples of (R,) columns, as in the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

EPS = float(np.float32(1e-6))
BIG = float(np.float32(1e30))
TINY = float(np.float32(1e-30))


class Nearest(NamedTuple):
    """Nearest hit per ray: distance, triangle id (scene order), the
    triangle's barycentrics, and — from the sub-block traversal only — the
    winner's global leaf slot (an index into ``SceneData.sh_slot``)."""

    t: torch.Tensor  # (R,) float32, BIG on a miss
    tri: torch.Tensor  # (R,) int32
    u: torch.Tensor  # (R,) float32
    v: torch.Tensor  # (R,) float32
    slot: torch.Tensor | None = None  # (R,) int32


def init_nearest(num_rays: int, device) -> Nearest:
    return Nearest(
        t=torch.full((num_rays,), BIG, dtype=torch.float32, device=device),
        tri=torch.zeros(num_rays, dtype=torch.int32, device=device),
        u=torch.zeros(num_rays, dtype=torch.float32, device=device),
        v=torch.zeros(num_rays, dtype=torch.float32, device=device))


def mt_single(o3, d3, v0, e1, e2, face):
    """Möller–Trumbore for per-ray triangle data.  ``o3``/``d3`` are
    3-tuples of (R,) columns; v0/e1/e2/face are 3-tuples of (R,) columns
    too (the triangle each ray is tested against); all broadcast.

    Returns (valid, t, u, v) with the reference's rejection rules
    (fragment.glsl:110-143), in the JAX kernels' operation order
    (``opengl_raytracer_tpu/ops/pallas_traversal.py:203-215``).
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


def slab_test(origin, inv_dir, box_min, box_max):
    """Slab AABB test (fragment.glsl:181-204) over (..., 3) tensors.

    Returns the entry distance, clamped to 0 when the origin is inside the
    box, or -1 on a miss or a box fully behind.  A NaN from ``0 * inf``
    (an axis-parallel ray on a slab plane) propagates through the min and
    max and counts as a miss, as in the JAX package."""
    t_min = (box_min - origin) * inv_dir
    t_max = (box_max - origin) * inv_dir
    near = torch.minimum(t_min, t_max).amax(dim=-1)
    far = torch.maximum(t_min, t_max).amin(dim=-1)
    hit = (far >= near) & (far >= 0.0)
    return torch.where(hit, near.clamp_min(0.0), -1.0)


@contextlib.contextmanager
def _full_fp32_matmul():
    """Float32 matmuls on the card in full float32, never TF32: TF32 keeps
    about three decimal digits, which corrupts the barycentric accept and
    reject decisions (``opengl_raytracer_tpu/ops/intersect.py:152-155``)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def raycast_brute(scene, o3, d3, active=None, tri_chunk: int = 2048) -> Nearest:
    """Nearest hit by a dense sweep over all triangles.

    Matmul form: per triangle chunk, every per-(ray, triangle) quantity is
    an ``(R, 3) @ (3, C)`` product:

        det = d . face
        t   = (v0.face - o.face) / det
        u   = -((o x d).e2 - d.(e2 x v0)) / det
        v   =  ((o x d).e1 - d.(e1 x v0)) / det

    ``o3``/``d3`` are 3-tuples of (R,) columns and ``active`` an optional
    (R,) bool mask whose False rays report ``t = BIG``.  A batch with no
    active ray reports ``init_nearest``'s misses; the choice is made on the
    device (no host sync), so a captured step can run the sweep."""
    origin = torch.stack(tuple(o3), dim=1)
    direction = torch.stack(tuple(d3), dim=1)
    R = origin.shape[0]
    near = init_nearest(R, origin.device)
    T = scene.v0.shape[0]
    C = min(tri_chunk, T)
    cross_od = torch.linalg.cross(origin, direction)
    t_best, tri, u_best, v_best = near.t, near.tri, near.u, near.v
    with _full_fp32_matmul():
        for base in range(0, T, C):
            v0, e1, e2, face = (x[base:base + C] for x in
                                (scene.v0, scene.e1, scene.e2, scene.face))
            d0 = (v0 * face).sum(dim=1)
            q1 = torch.linalg.cross(e1, v0)
            q2 = torch.linalg.cross(e2, v0)
            det = direction @ face.T
            inv_det = 1.0 / det
            t = (d0[None, :] - origin @ face.T) * inv_det
            u = -(cross_od @ e2.T - direction @ q2.T) * inv_det
            v = (cross_od @ e1.T - direction @ q1.T) * inv_det
            valid = ((det.abs() >= EPS) & (t > EPS) & (u >= 0.0) & (v >= 0.0)
                     & ((u + v) <= 1.0))
            ts = torch.where(valid, t, BIG)
            arg = torch.argmin(ts, dim=1, keepdim=True)  # lowest index wins
            bt = ts.gather(1, arg)[:, 0]
            better = bt < t_best  # strict <, fragment.glsl:275
            t_best = torch.where(better, bt, t_best)
            tri = torch.where(better, (arg[:, 0] + base).to(torch.int32), tri)
            u_best = torch.where(better, u.gather(1, arg)[:, 0], u_best)
            v_best = torch.where(better, v.gather(1, arg)[:, 0], v_best)
    if active is not None:
        t_best = torch.where(active, t_best, BIG)
        any_active = active.any()
        tri, u_best, v_best = (torch.where(any_active, x, y) for x, y in (
            (tri, near.tri), (u_best, near.u), (v_best, near.v)))
    return Nearest(t=t_best, tri=tri, u=u_best, v=v_best)


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


def shading_table(scene, nearest: Nearest):
    """The material table and the index column that select each ray's
    shading row (``opengl_raytracer_tpu/ops/intersect.py:244-248``): the
    slot-order rows ``sh_slot`` by leaf slot when the traversal reports
    slots, else the triangle-order rows ``sh_abc`` by triangle."""
    if nearest.slot is not None and scene.sh_slot.shape[0] > 0:
        return scene.sh_slot, nearest.slot
    return scene.sh_abc, nearest.tri


def finalize_hit_soa(table, index, o3, d3, nearest: Nearest) -> HitSoA:
    """Hit point, smooth barycentric normal with degenerate fallback to the
    geometric normal, flip toward the ray, and the material fetch
    (fragment.glsl:146-176).  Materials are the rows ``table[index]``, the
    index clamped into the table (see :func:`shading_table`)."""
    did_hit = nearest.t < BIG
    point = tuple(o3[a] + d3[a] * nearest.t for a in range(3))

    abc = table[index.long().clamp(0, table.shape[0] - 1)].T
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
