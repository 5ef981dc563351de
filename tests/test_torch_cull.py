"""The sign test before the IEEE division of a ray-triangle pair.

G7 (``csrc/bvh_walk.cuh:ahead``) skips the division ``1 / det`` of a
pair unless ``|det| >= EPS`` and ``num * det > 0``, where ``t = num *
(1 / det)``; ``intersect.divides`` is that test in torch.  It is exact
only if every pair it skips is one the plain versions reject, whatever
the floats: these tests compute t and the accept decision as the plain
versions do, in torch float32, and assert that implication

* on the cross product of edge values of ``num`` and ``det``: +-0,
  subnormals (whose product with ``det`` rounds to 0), ``|det|`` at, just
  below and just above 1e-6, values near FLT_MAX, NaN and +-inf, against
  a nearest hit ``bt`` of +-BIG and others;
* on whole pairs drawn by ``hypothesis`` (seeded, edge values included),
  for the walks' form ``num = -((o - v0) . face)``
  (``intersect.mt_single``; G7 and G9) and the sweep's ``num = v0.face -
  o.face`` (``intersect._sweep_plain``; G8), each accept decision the
  plain version's own.

No tolerance: the decisions are compared exactly.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from opengl_raytracer_torch.ops.intersect import (BIG, EPS, _dot3, divides,
                                                  mt_single)

F32 = np.float32
TINY_SUB = float(np.finfo(F32).smallest_subnormal)
MAX = float(np.finfo(F32).max)
EPS32 = F32(EPS)
EDGES = [0.0, -0.0, TINY_SUB, -TINY_SUB, 1e-40, -1e-40,
         float(np.finfo(F32).tiny), -float(np.finfo(F32).tiny),
         float(EPS32), -float(EPS32),
         float(np.nextafter(EPS32, F32(0))), -float(np.nextafter(EPS32,
                                                               F32(0))),
         float(np.nextafter(EPS32, F32(1))), -float(np.nextafter(EPS32,
                                                               F32(1))),
         1e-3, -1e-3, 0.5, -0.5, 1.0, -1.0, 3.0, -7.5, 1e30, -1e30,
         3e38, -3e38, MAX, -MAX, float("inf"), float("-inf"), float("nan")]
BTS = [BIG, -BIG, 2.0, float(EPS32), MAX]


def _rejected_by_plain(num, det, bt):
    """The plain versions' accept decision on t's side: ``|det| >= EPS``,
    ``t = num * (1 / det) > EPS`` and ``t < bt``, in float32 as torch
    computes it (u and v can only reject more)."""
    t = num * (1.0 / det)
    return ~((det.abs() >= EPS) & (t > EPS) & (t < bt))


@pytest.mark.parametrize("bt", BTS, ids=[f"bt={b:g}" for b in BTS])
def test_skipped_edge_pairs_are_rejected(bt):
    num, det = (torch.tensor(x, dtype=torch.float32)
                for x in np.meshgrid(EDGES, EDGES, indexing="ij"))
    skipped = ~divides(num, det)
    assert skipped.any() and (~skipped).any()
    rejected = _rejected_by_plain(num, det, torch.tensor(bt))
    assert bool(rejected[skipped].all())
    # the test is exactly the sign of t where |det| >= EPS: where it
    # divides and t is finite and nonzero, t is positive
    t = num * (1.0 / det)
    kept = ~skipped & (t != 0) & t.isfinite()
    assert bool((t[kept] > 0).all())


def _floats():
    return st.one_of(st.sampled_from(EDGES),
                     st.floats(width=32, allow_nan=True, allow_infinity=True,
                               allow_subnormal=True),
                     st.floats(-10.0, 10.0, width=32))


_vec = st.tuples(_floats(), _floats(), _floats())


def _cols(*vs):
    return tuple(torch.tensor([v[a] for v in vs], dtype=torch.float32)
                 for a in range(3))


@settings(max_examples=400, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.tuples(_vec, _vec, _vec, _vec, _vec, _vec,
                          st.sampled_from(BTS)), min_size=1, max_size=16))
def test_skipped_pairs_are_rejected_by_the_plain_versions(pairs):
    o, d, v0, e1, e2, face = (_cols(*(p[k] for p in pairs))
                              for k in range(6))
    bt = torch.tensor([p[6] for p in pairs], dtype=torch.float32)
    det = _dot3(d, face)
    # the walks (intersect.mt_single): num = -((o - v0) . face)
    r = tuple(a - b for a, b in zip(o, v0))
    valid, t, _, _ = mt_single(o, d, v0, e1, e2, face)
    skipped = ~divides(-_dot3(r, face), det)
    assert bool((~(valid & (t < bt)))[skipped].all())
    # G8 (intersect._sweep_plain): num = v0.face - o.face
    num = _dot3(v0, face) - _dot3(o, face)
    t8 = num * (1.0 / det)
    near_t = (det.abs() >= EPS) & (t8 > EPS) & (t8 < bt)
    assert bool((~near_t)[~divides(num, det)].all())

