"""K1's plain torch version and the part-chaining wrapper against the JAX
package's ``raycast_subblock`` (interpret mode) and ``raycast_packet``.

Both sides read the same tables (``scene_from_numpy`` of the JAX
SceneData).  Tolerances:

* ``t`` within ``rtol=atol=1e-6``, widened per ray by the rounding bound
  of ``t = -(r.face)/det``: XLA contracts the dot products into FMAs and
  eager torch does not, and a ray starting next to a triangle's plane
  cancels ``r.face`` (4 ulps of ``sum|r_a face_a| / |det|``);
* the hit triangle equal on every hit ray except where the port's triangle
  is hit at the same ``t`` (the JAX kernel orders children by its packet's
  dominant octant, the port by the ray's own, so exact ties may resolve
  differently);
* u/v within 1e-5 where the triangles agree; inactive rays report
  ``t = BIG``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import opengl_raytracer_tpu.ops.wide2 as jwide2
from opengl_raytracer_tpu.models.rect import Rect as JRect
from opengl_raytracer_tpu.models.scene import Scene as JScene
from opengl_raytracer_tpu.models.trisoup import Triangles as JTriangles
from opengl_raytracer_tpu.ops.subblock_traversal import raycast_subblock as j_subblock
from opengl_raytracer_tpu.ops.traversal import raycast_packet as j_packet

from opengl_raytracer_torch import scene_from_numpy
from opengl_raytracer_torch.ops.intersect import BIG
from opengl_raytracer_torch.ops.subblock_traversal import (overflow_tensor,
                                                           raycast_subblock)


def _jax_scene(n_tris, budget=None, monkeypatch=None):
    if budget is not None:
        orig = jwide2.build_subblock_parts
        monkeypatch.setattr(jwide2, "build_subblock_parts",
                            lambda *a, **k: orig(*a, budget_bytes=budget))
    rng = np.random.default_rng(0)
    tris = rng.uniform(-3, 3, (n_tris, 3, 3)).astype(np.float32)
    objs = [JTriangles(tris, color=(0.5, 0.5, 0.5), roughness=1.0),
            # a box around the soup: shared quad edges give exact-t ties
            JRect([10, 10, 10], [0, 0, 0], [0, 0, 0], [0.8, 0.8, 0.8])]
    data = JScene(objs, max_leaf_tris=16).send()
    fields = dict(
        p2_node_rows=np.asarray(data.p2_node_rows),
        p2_tri_rows=np.asarray(data.p2_tri_rows),
        p2_remap=np.asarray(data.p2_remap),
        p2_extra=[tuple(np.asarray(x) for x in p) for p in data.p2_extra],
        sh_slot=np.asarray(data.sh_slot),
        node_min=np.asarray(data.node_min),
        node_max=np.asarray(data.node_max))
    return data, scene_from_numpy(fields, "cpu")


def _rays(R, seed=1):
    g = np.random.default_rng(seed)
    o = g.uniform(-6, 6, (3, R)).astype(np.float32)
    d = g.normal(size=(3, R)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    d[:, :4] = np.asarray([[1, 0, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                          np.float32).T  # axis-parallel: clamped inverses
    return o, d


def _mt(o, d, v0, e1, e2, face):
    """Reference Möller–Trumbore in float64 for the tie check."""
    det = (d * face).sum(0)
    r = o - v0
    t = -(r * face).sum(0) / det
    p = np.cross(r, d, axis=0)
    u = -(e2 * p).sum(0) / det
    v = (e1 * p).sum(0) / det
    ok = (np.abs(det) >= 1e-6) & (t > 1e-6) & (u >= -1e-5) & (v >= -1e-5) \
        & (u + v <= 1 + 1e-5)
    return ok, t


def _check(jdata, ref, got, o, d, active=None):
    rt, gt = np.asarray(ref.t), got.t.numpy()
    hit = rt < 1e29
    assert hit.sum() > len(rt) // 8
    np.testing.assert_array_equal(gt[~hit], rt[~hit])
    if active is not None:
        assert (gt[~active] == BIG).all()
    tris = [np.asarray(x, np.float64) for x in
            (jdata.v0, jdata.e1, jdata.e2, jdata.face)]
    rtri, gtri = np.asarray(ref.tri)[hit], got.tri.numpy()[hit]
    v0, face = tris[0][rtri].T, tris[3][rtri].T
    cond = (np.abs((o[:, hit] - v0) * face).sum(0)
            / np.abs((d[:, hit] * face).sum(0)))
    tol = 1e-6 + 1e-6 * np.abs(rt[hit]) + 4 * 2.0**-24 * cond
    assert (np.abs(gt[hit] - rt[hit]) <= tol).all()
    diff = rtri != gtri
    if diff.any():
        # every disagreement must be a tie: the port's triangle is hit at
        # the reference's t too
        idx = gtri[diff]
        ok, t = _mt(o[:, hit][:, diff].astype(np.float64),
                    d[:, hit][:, diff].astype(np.float64),
                    *(x[idx].T for x in tris))
        assert ok.all(), "port picked a triangle the ray does not hit"
        np.testing.assert_allclose(t, rt[hit][diff], rtol=1e-5, atol=1e-5)
    same = ~diff
    for f in ("u", "v"):
        np.testing.assert_allclose(np.asarray(getattr(ref, f))[hit][same],
                                   getattr(got, f).numpy()[hit][same],
                                   atol=1e-5)
    return diff.sum()


def _run_port(tdata, o, d, active=None):
    ov = overflow_tensor("cpu")
    ov.zero_()
    act = None if active is None else torch.from_numpy(active)
    got = raycast_subblock(tdata, tuple(torch.from_numpy(x) for x in o),
                           tuple(torch.from_numpy(x) for x in d), act)
    assert int(ov.item()) == 0
    return got


@pytest.mark.parametrize("parts", ["single", "multi"])
def test_plain_matches_jax_subblock(parts, monkeypatch):
    """The JAX kernel in interpret mode, with an active mask, on a
    single-part scene and on a scene split into several parts."""
    budget = 96 * 1024 if parts == "multi" else None  # two parts
    jdata, tdata = _jax_scene(600 if parts == "multi" else 257, budget,
                              monkeypatch)
    assert len(tdata.parts) == (2 if parts == "multi" else 1)
    R = 512
    o, d = _rays(R)
    active = np.random.default_rng(7).uniform(size=R) < 0.7
    ref = j_subblock(jdata, tuple(jnp.asarray(x) for x in o),
                     tuple(jnp.asarray(x) for x in d), jnp.asarray(active),
                     interpret=True)
    got = _run_port(tdata, o, d, active)
    _check(jdata, ref, got, o, d, active)


@pytest.mark.parametrize("parts", ["single", "multi"])
def test_plain_matches_jax_packet(parts, monkeypatch):
    """Wider batches against the XLA packet traversal (no interpret mode):
    every ray, and hits in the box's walls where quads share edges."""
    budget = 64 * 1024 if parts == "multi" else None  # eight parts
    jdata, tdata = _jax_scene(1200 if parts == "multi" else 257, budget,
                              monkeypatch)
    assert len(tdata.parts) == (8 if parts == "multi" else 1)
    R = 4096
    o, d = _rays(R, seed=2)
    ref = j_packet(jdata, jnp.asarray(o.T), jnp.asarray(d.T),
                   max_leaf_tris=int(np.asarray(jdata.node_count).max()))
    got = _run_port(tdata, o, d)
    assert _check(jdata, ref, got, o, d) < R // 100
