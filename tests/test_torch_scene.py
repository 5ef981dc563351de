"""The torch port's scene tables and sort keys against the JAX package.

Both packages build every table with the same builders from the same
objects (the per-triangle arrays, the binary BVH, the wide-BVH tiles, the
octet-aligned triangle tiles, the sub-block parts and both shading
tables), so every table must be BIT-equal (compared as raw 32-bit
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
from opengl_raytracer_torch.ops.wide_bvh import collapse_wide, validate_wide


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


# SceneData fields both packages have, besides the sub-block parts
_SHARED = ("v0", "e1", "e2", "face", "node_min", "node_max", "node_miss",
           "node_first", "node_count", "pw_tiles", "pw_entry",
           "pl_tri_tiles", "pl_remap", "sh_abc", "sh_slot")


def _jax_fields(data):
    """np.asarray of every field of a JAX SceneData."""
    fields = {k: np.asarray(getattr(data, k)) for k in data._fields
              if k != "p2_extra"}
    fields["p2_extra"] = [tuple(np.asarray(x) for x in p)
                          for p in data.p2_extra]
    return fields


def _assert_scene_equal(jdata, tdata):
    for name in _SHARED:
        _assert_bit_equal(getattr(jdata, name),
                          getattr(tdata, name).numpy(), name)
    assert len(tdata.p2_extra) == len(jdata.p2_extra)
    jparts = [(jdata.p2_node_rows, jdata.p2_tri_rows, jdata.p2_remap),
              *jdata.p2_extra]
    for k, (jp, tp) in enumerate(zip(jparts, tdata.parts)):
        for name, ja, ta in zip(("node_rows", "tri_rows", "remap"), jp, tp):
            _assert_bit_equal(ja, ta.numpy(), f"part {k} {name}")
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


@pytest.mark.parametrize("leaf", [8, 16, 32, "no_bvh"])
def test_wide_tables_bit_equal(leaf):
    """The wide-BVH and octet tiles, the binary BVH, the per-triangle
    arrays and sh_abc at every leaf size, and for the single-leaf
    pseudo-BVH of build_bvh=False; the port's stack bound recomputed from
    pw_entry equals collapse_wide's."""
    kw = (dict(build_bvh=False) if leaf == "no_bvh"
          else dict(max_leaf_tris=leaf))
    jdata = JScene(_objects(JRect, JTriangles, 300), **kw).send()
    scene = Scene(_objects(Rect, Triangles, 300), **kw)
    tdata = scene.send("cpu")
    _assert_scene_equal(jdata, tdata)
    if leaf == "no_bvh":
        assert scene.bvh is None
        assert tdata.node_count.tolist() == [scene.total_triangles]
    else:
        # the leaves' first octets, as Scene.fields lays the octets out
        counts = scene.bvh.node_count
        octets = -(-counts[counts > 0].astype(np.int64) // 8)
        first = np.zeros(len(counts), np.int32)
        first[counts > 0] = np.concatenate(([0], np.cumsum(octets)))[:-1]
        wide = collapse_wide(scene.bvh, first)
        validate_wide(wide, scene.bvh)
        np.testing.assert_array_equal(wide.entry, tdata.pw_entry.numpy())
        assert wide.max_stack == tdata.pw_max_stack


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
