"""Ray-triangle and ray-box intersection, brute force, and hit resolution.

* :func:`mt_single` — the reference's Möller–Trumbore test in its plane-
  determinant form (fragment.glsl:106-177) with ``EPS = 1e-6``
  parallel/self-hit rejection, on per-ray gathered triangles.  It is the
  triangle test of the traversals' plain versions.
* :func:`slab_test` — the slab AABB test (fragment.glsl:181-204).
* :func:`raycast_brute` — every ray against every triangle (the JAX
  package's ``raycast_brute``, ``opengl_raytracer_tpu/ops/intersect.py:
  120-205``): on the card one launch of the sweep kernel G8
  (``csrc/brute_sweep.cu``) over the scene's triangle records
  (``SceneData.tri_records``, :func:`pack_tri_records`), on the CPU its
  plain version :func:`_sweep_plain` over the same records, the JAX
  package's plane-determinant formulas in chunks of 2048 triangles; the
  lowest index wins a tie.
* :func:`finalize_hit_soa` — the nearest-hit record resolved into the
  shader's Hit fields (fragment.glsl:146-176); with the integrator's
  scatter and state update it forms the shade kernel's plain version;
  :class:`Hit` and :func:`finalize_hit` are its AoS form (the JAX
  package's compatibility surface; the main path does not call them).

Vec3 quantities travel as 3-tuples of (R,) columns, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opengl_raytracer_torch.ops import _kernels

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


def divides(num, det):
    """Where a kernel with the sign test (G7, ``csrc/bvh_walk.cu``) runs
    the IEEE division of ``t = num * (1 / det)``: ``|det| >= EPS`` and
    ``num * det > 0`` (``csrc/bvh_walk.cuh:ahead``), the pairs whose t can
    pass ``t > EPS``.  With ``|det| >= EPS``, ``1 / det`` is nonzero with
    ``det``'s sign, so where ``num`` is +-0, NaN or of the other sign, t
    is +-0, negative or NaN, and where the product of same-signed values
    rounds to +0, ``|t| < 2^-149 / det^2 < 1e-32``: a pair this gives
    False is one :func:`mt_single` (and the sweep) rejects."""
    return (det.abs() >= EPS) & (num * det > 0.0)


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


def _dot3(a, b):
    """``a . b`` for 3-tuples of broadcastable columns, one torch ``mul`` or
    ``add`` a step in the kernels' order ``(a0 b0 + a1 b1) + a2 b2``: no
    library call that a CUDA build could contract into an FMA."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    """``a x b`` for 3-tuples of columns, each component ``a_i b_j - a_j
    b_i`` as two ``mul`` and one ``sub``."""
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def pack_tri_records(v0, e1, e2, face) -> torch.Tensor:
    """The (T, 12) float32 triangle records G7, G8 and G9 read, packed at
    upload (``SceneData.tri_records``): v0, e1, e2 and face a row, 48
    bytes, three 16-byte loads."""
    return torch.cat((v0, e1, e2, face), dim=1).contiguous()


def unpack_tri_records(rec: torch.Tensor) -> tuple:
    """(v0, e1, e2, face), each (T, 3), from :func:`pack_tri_records`'s
    records, bit for bit."""
    return tuple(rec[:, 3 * k:3 * k + 3].contiguous() for k in range(4))


def _sweep_plain(scene, o3, d3, active=None, tri_chunk: int = 2048,
                 counts: bool = False):
    """Plain torch version of the sweep kernel (G8): the JAX package's
    plane-determinant formulas over (R, C) arrays, C = ``tri_chunk``
    triangles at a time, over the columns of the scene's triangle
    records,

        det = d . face
        t   = (v0.face - o.face) / det
        u   = -((o x d).e2 - d.(e2 x v0)) / det
        v   =  ((o x d).e1 - d.(e1 x v0)) / det

    each product written out as torch ``mul``/``add``/``sub`` in the
    kernel's order, so the card computes the same bits.  The lowest index
    wins a tie within a chunk (``argmin``) and a strict ``<`` across
    chunks: the kernel's sequential strict ``<``.  A dead ray reports
    ``init_nearest``'s miss.  With ``counts``, also a (2, R) int64 tensor
    of each ray's pair tests and candidates (pairs with ``|det| >= EPS``
    and ``EPS < t <`` the nearest valid t before it, whose u and v the
    kernel computes)."""
    o = tuple(x[:, None] for x in o3)
    d = tuple(x[:, None] for x in d3)
    R = o3[0].shape[0]
    dev = o3[0].device
    near = init_nearest(R, dev)
    t_best, tri, u_best, v_best, _ = near
    work = torch.zeros((2, R), dtype=torch.int64, device=dev) if counts \
        else None
    cod = _cross3(o, d)
    cols = unpack_tri_records(scene.tri_records)
    T = scene.num_tris
    for base in range(0, T, min(tri_chunk, T)):
        v0, e1, e2, face = (tuple(x[base:base + tri_chunk, a][None, :]
                                  for a in range(3)) for x in cols)
        d0 = _dot3(v0, face)
        q1 = _cross3(e1, v0)
        q2 = _cross3(e2, v0)
        det = _dot3(d, face)
        inv_det = 1.0 / det
        t = (d0 - _dot3(o, face)) * inv_det
        u = -(_dot3(cod, e2) - _dot3(d, q2)) * inv_det
        v = (_dot3(cod, e1) - _dot3(d, q1)) * inv_det
        near_t = (det.abs() >= EPS) & (t > EPS)
        valid = near_t & (u >= 0.0) & (v >= 0.0) & ((u + v) <= 1.0)
        ts = torch.where(valid, t, BIG)
        if counts:
            before = torch.cat((t_best[:, None], ts[:, :-1]), 1).cummin(1)[0]
            work[0] += t.shape[1]
            work[1] += (near_t & (t < before)).sum(1)
        arg = torch.argmin(ts, dim=1, keepdim=True)  # lowest index wins
        bt = ts.gather(1, arg)[:, 0]
        better = bt < t_best  # strict <, fragment.glsl:275
        t_best = torch.where(better, bt, t_best)
        tri = torch.where(better, (arg[:, 0] + base).to(torch.int32), tri)
        u_best = torch.where(better, u.gather(1, arg)[:, 0], u_best)
        v_best = torch.where(better, v.gather(1, arg)[:, 0], v_best)
    out = Nearest(t=t_best, tri=tri, u=u_best, v=v_best)
    if active is not None:
        out = Nearest(*(torch.where(active, x, y)
                        for x, y in zip(out[:4], near[:4])))
    if not counts:
        return out
    return out, work if active is None else torch.where(active, work, 0)


def _sweep_cuda(scene, o3, d3, active=None) -> Nearest:
    dev = o3[0].device
    R = o3[0].shape[0]
    req = _kernels.require
    for name, x in zip(("ox", "oy", "oz", "dx", "dy", "dz"), (*o3, *d3)):
        req(x, name, torch.float32, dev, R)
    if active is not None:
        req(active, "active", torch.bool, dev, R)
    T = scene.num_tris
    tris = scene.tri_records
    req(tris, "triangle records", torch.float32, dev, T * 12)
    out = Nearest(*(torch.empty(R, dtype=dt, device=dev) for dt in (
        torch.float32, torch.int32, torch.float32, torch.float32)))
    _kernels.launch(
        "oglrt_brute_sweep", "brute_sweep", dev,
        *(x.data_ptr() for x in (*o3, *d3)),
        None if active is None else active.data_ptr(), tris.data_ptr(), T,
        *(x.data_ptr() for x in out[:4]), R)
    return out


def raycast_brute(scene, o3, d3, active=None) -> Nearest:
    """Nearest hit by a dense sweep over all triangles.  ``o3``/``d3`` are
    3-tuples of (R,) columns and ``active`` an optional (R,) bool mask
    whose False rays report a miss (``init_nearest``'s).  CUDA rays: one
    launch of ``csrc/brute_sweep.cu`` (G8) over the scene's triangle
    records; CPU rays: :func:`_sweep_plain`.  The two agree bit for bit on
    the card."""
    o3 = tuple(x.contiguous() for x in o3)
    d3 = tuple(x.contiguous() for x in d3)
    if o3[0].is_cuda:
        return _sweep_cuda(scene, o3, d3, active)
    return _sweep_plain(scene, o3, d3, active)


class Hit(NamedTuple):
    """Per-ray nearest-hit record (the shader's ``Hit`` struct,
    fragment.glsl:68-81) with vec3 fields as (R, 3) tensors: the JAX
    package's ``Hit``."""

    did_hit: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,) float32
    point: torch.Tensor  # (R, 3)
    normal: torch.Tensor  # (R, 3)
    color: torch.Tensor  # (R, 3)
    emission: torch.Tensor  # (R,)
    emission_color: torch.Tensor  # (R, 3)
    roughness: torch.Tensor  # (R,)


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


def finalize_hit(scene, origin, direction, nearest: Nearest) -> Hit:
    """AoS wrapper over :func:`finalize_hit_soa` (the JAX package's
    ``finalize_hit``): ``origin`` and ``direction`` are (R, 3), the
    materials those of :func:`shading_table`."""
    h = finalize_hit_soa(*shading_table(scene, nearest),
                         tuple(origin[..., a] for a in range(3)),
                         tuple(direction[..., a] for a in range(3)), nearest)
    return Hit(did_hit=h.did_hit, t=h.t, point=torch.stack(h.point, -1),
               normal=torch.stack(h.normal, -1),
               color=torch.stack(h.color, -1), emission=h.emission,
               emission_color=torch.stack(h.emission_color, -1),
               roughness=h.roughness)
