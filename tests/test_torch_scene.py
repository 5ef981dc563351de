"""The torch port's scene tables and sort keys against the JAX package.

Both packages build the sub-block tables with the same builder from the
same objects, so every table must be BIT-equal (compared as raw 32-bit
patterns); the Morton/octant sort keys must be bit-equal too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import opengl_raytracer_tpu.ops.wide2 as jwide2
from opengl_raytracer_tpu.models.rect import Rect as JRect
from opengl_raytracer_tpu.models.scene import Scene as JScene
from opengl_raytracer_tpu.models.trisoup import Triangles as JTriangles
from opengl_raytracer_tpu.ops.morton import ray_sort_keys_soa as j_keys

import opengl_raytracer_torch.models.scene as tscene_mod
from opengl_raytracer_torch import Rect, Scene, Triangles, scene_from_numpy
from opengl_raytracer_torch.ops.morton import ray_sort_keys_soa


def _objects(rect_cls, tri_cls, n_tris):
    rng = np.random.default_rng(5)
    tris = rng.uniform(-3, 3, (n_tris, 3, 3)).astype(np.float32)
    return [
        rect_cls([8, 5, 0.1], [0, 0, 6], [0, 0, 0], [1, 0.25, 0.3],
                 roughness=1, scale=1),
        rect_cls([2, 2, 0.25], [0, 4, 0], [-90, 0, 0], [0, 0, 0],
                 [1, 1, 1], 1.5, scale=1),
        tri_cls(tris, color=(0.96, 0.96, 0.86), roughness=0.5),
    ]


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_bit_equal(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    assert a.dtype.itemsize == b.dtype.itemsize, name
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


def _jax_fields(data):
    return dict(
        p2_node_rows=np.asarray(data.p2_node_rows),
        p2_tri_rows=np.asarray(data.p2_tri_rows),
        p2_remap=np.asarray(data.p2_remap),
        p2_extra=[tuple(np.asarray(x) for x in p) for p in data.p2_extra],
        sh_slot=np.asarray(data.sh_slot),
        node_min=np.asarray(data.node_min),
        node_max=np.asarray(data.node_max),
    )


def _assert_scene_equal(jdata, tdata):
    assert len(tdata.p2_extra) == len(jdata.p2_extra)
    jparts = [(jdata.p2_node_rows, jdata.p2_tri_rows, jdata.p2_remap),
              *jdata.p2_extra]
    for k, (jp, tp) in enumerate(zip(jparts, tdata.parts)):
        for name, ja, ta in zip(("node_rows", "tri_rows", "remap"), jp, tp):
            _assert_bit_equal(ja, ta.numpy(), f"part {k} {name}")
    _assert_bit_equal(jdata.sh_slot, tdata.sh_slot.numpy(), "sh_slot")
    _assert_bit_equal(np.asarray(jdata.node_min)[0], tdata.root_min, "root_min")
    _assert_bit_equal(np.asarray(jdata.node_max)[0], tdata.root_max, "root_max")


def test_single_part_tables_bit_equal():
    jdata = JScene(_objects(JRect, JTriangles, 300)).send()
    tdata = Scene(_objects(Rect, Triangles, 300)).send("cpu")
    assert tdata.p2_node_rows.shape[0] > 0 and len(tdata.p2_extra) == 0
    _assert_scene_equal(jdata, tdata)


def test_multi_part_tables_bit_equal(monkeypatch):
    """Shrinking the table budget splits the scene into parts (as in
    tests/test_subblock.py's multi-part test); both packages must split it
    the same way."""
    jorig = jwide2.build_subblock_parts
    torig = tscene_mod.build_subblock_parts
    monkeypatch.setattr(jwide2, "build_subblock_parts",
                        lambda *a, **k: jorig(*a, budget_bytes=64 * 1024))
    monkeypatch.setattr(tscene_mod, "build_subblock_parts",
                        lambda *a, **k: torig(*a, budget_bytes=64 * 1024))
    jdata = JScene(_objects(JRect, JTriangles, 1200), max_leaf_tris=16).send()
    tdata = Scene(_objects(Rect, Triangles, 1200), max_leaf_tris=16).send("cpu")
    assert len(tdata.p2_extra) >= 1
    _assert_scene_equal(jdata, tdata)


def test_scene_from_numpy_round_trip():
    """scene_from_numpy of the JAX SceneData's fields carries every table
    over unchanged."""
    jdata = JScene(_objects(JRect, JTriangles, 300)).send()
    _assert_scene_equal(jdata, scene_from_numpy(_jax_fields(jdata), "cpu"))


@pytest.mark.parametrize("R", [1000, 4096])
def test_morton_keys_bit_exact(R):
    g = np.random.default_rng(R)
    lo = np.asarray([-4.0, -2.5, -3.0], np.float32)
    hi = np.asarray([5.0, 3.5, 2.0], np.float32)
    # origins partly outside the bounds exercise the clamps
    o = g.uniform(-6, 6, (3, R)).astype(np.float32)
    d = g.normal(size=(3, R)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    d[:, :8] = np.asarray([[1, 0, 0]] * 8, np.float32).T  # axis-parallel
    alive = g.uniform(size=R) < 0.7
    ref = np.asarray(j_keys(tuple(jnp.asarray(x) for x in o),
                            tuple(jnp.asarray(x) for x in d),
                            jnp.asarray(lo), jnp.asarray(hi),
                            jnp.asarray(alive)))
    got = ray_sort_keys_soa(tuple(torch.from_numpy(x) for x in o),
                            tuple(torch.from_numpy(x) for x in d),
                            lo, hi, torch.from_numpy(alive)).numpy()
    np.testing.assert_array_equal(ref.astype(np.int64), got)
    assert (got[~alive] == 0xFFFFFFFF).all() and (got[alive] < 0xFFFFFFFF).all()
