"""The torch port's scene tables and sort keys against the JAX package.

Both packages build every table with the same builders from the same
objects (the per-triangle arrays, the binary BVH, the wide-BVH tiles, the
octet-aligned triangle tiles, the sub-block parts and both shading
tables), so every table of ``Scene.fields()`` must be BIT-equal (compared
as raw 32-bit patterns) to the JAX SceneData's, and the port's upload,
each table packed into its kernel's layout, must give them back bit for
bit; the Morton/octant sort keys must be bit-equal too.

Every port test module that builds a JAX scene imports :func:`jax_native`
from here, which makes the JAX package's native library load first
(:func:`wait_for_jax_native`).
"""

import fcntl
import functools
import os
import shutil
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import opengl_raytracer_tpu.ops.wide2 as jwide2
from opengl_raytracer_tpu.native import loader as jnative
from opengl_raytracer_tpu.models.rect import Rect as JRect
from opengl_raytracer_tpu.models.scene import Scene as JScene
from opengl_raytracer_tpu.models.trisoup import Triangles as JTriangles
from opengl_raytracer_tpu.ops.morton import ray_sort_keys_soa as j_keys

import opengl_raytracer_torch.models.scene as tscene_mod
import opengl_raytracer_torch.ops.wide2 as twide2
from opengl_raytracer_torch import Rect, Scene, Triangles, scene_from_numpy
from opengl_raytracer_torch.ops.intersect import unpack_tri_records
from opengl_raytracer_torch.ops.morton import ray_sort_keys_soa
from opengl_raytracer_torch.ops.traversal import unpack_node_records
from opengl_raytracer_torch.ops.wide2 import unpack_k1
from opengl_raytracer_torch.ops.wide_bvh import (MAX_LEAF_COUNT, collapse_wide,
                                                 unpack_k3, validate_wide,
                                                 wide_max_stack)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_LOCK = os.path.join(_REPO, "build", "jax_native.lock")
NATIVE_WAIT_S = 120.0  # the JAX native build's own g++ timeout


def _settled(path, quiet_s=1.0):
    """Wait until ``path``, if it exists, has not been written for
    ``quiet_s`` seconds: a linker still writing it keeps moving its
    mtime."""
    while os.path.exists(path):
        age = time.time() - os.path.getmtime(path)
        if age >= quiet_s:
            return
        time.sleep(quiet_s - age)


def wait_for_jax_native():
    """The JAX package's native library, loaded in this process; fails the
    test if it will not load where g++ exists.

    The JAX loader (``opengl_raytracer_tpu/native/loader.py``) has g++
    write straight to its library file and latches its first failure.
    Under pytest-xdist, a worker that loads the file while another process
    is still writing it gets an ``OSError`` and keeps the JAX package's
    Python parser and BVH builder for good, and every later comparison of
    that worker against the port's native tables fails.  So, while the
    library is not loaded, this clears the latch and loads again, until it
    loads or ``NATIVE_WAIT_S`` pass, holding an ``fcntl`` lock on a file
    under ``build/`` so port workers never compile on top of each other.
    Without g++ both packages run their Python versions and there is
    nothing to wait for: it returns None."""
    if jnative._lib is not None:
        return jnative._lib
    if shutil.which("g++") is None:
        return None
    os.makedirs(os.path.dirname(NATIVE_LOCK), exist_ok=True)
    with open(NATIVE_LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            deadline = time.monotonic() + NATIVE_WAIT_S
            while True:
                _settled(jnative._LIB_PATH)
                jnative._tried = False
                lib = jnative.get_lib()
                if lib is not None:
                    return lib
                if time.monotonic() > deadline:
                    pytest.fail(f"the JAX package's native library "
                                f"{jnative._LIB_PATH} did not load within "
                                f"{NATIVE_WAIT_S:.0f} s although g++ is on "
                                f"the PATH: its tables would come from the "
                                f"Python builders")
                time.sleep(0.25)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@pytest.fixture(autouse=True, scope="module")
def jax_native():
    """Load the JAX package's native library before a module's first JAX
    scene, OBJ load or BVH build (:func:`wait_for_jax_native`); a module
    takes this fixture by importing it."""
    wait_for_jax_native()


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


# SceneData fields both packages' tables have, besides the sub-block parts
_SHARED = ("v0", "e1", "e2", "face", "node_min", "node_max", "node_miss",
           "node_first", "node_count", "pw_tiles", "pw_entry",
           "pl_tri_tiles", "pl_remap", "sh_abc", "sh_slot")
_NODES = ("node_min", "node_max", "node_miss", "node_first", "node_count")


def _jax_fields(data):
    """np.asarray of every field of a JAX SceneData."""
    fields = {k: np.asarray(getattr(data, k)) for k in data._fields
              if k != "p2_extra"}
    fields["p2_extra"] = [tuple(np.asarray(x) for x in p)
                          for p in data.p2_extra]
    return fields


def field_parts(fields):
    """The sub-block parts of a dict of tables named as the JAX
    ``SceneData`` fields: a (node_rows, tri_rows, remap) a part, in part
    order; none where the scene has no sub-block tables."""
    if np.shape(fields["p2_node_rows"])[0] == 0:
        return []
    return [tuple(np.asarray(x) for x in p) for p in (
        (fields["p2_node_rows"], fields["p2_tri_rows"], fields["p2_remap"]),
        *fields["p2_extra"])]


def _assert_upload_equal(fields, tdata):
    """The uploaded tables give ``fields`` back bit for bit: each part's
    K1 tables (``unpack_k1``) and remap, K3's (``unpack_k3``), the node and
    triangle records, ``pl_remap``, the shading rows, the root bounds, and
    the scalars."""
    parts = field_parts(fields)
    assert len(tdata.k1_parts) == len(parts)
    for k, (p, (nodes, octets, remap)) in enumerate(zip(parts,
                                                        tdata.k1_parts)):
        got = (*unpack_k1(nodes.numpy(), octets.numpy()), remap.numpy())
        for name, ref, x in zip(("node_rows", "tri_rows", "remap"), p, got):
            _assert_bit_equal(ref, x, f"part {k} {name}")
    node_count = np.asarray(fields["node_count"])
    if node_count.max() > MAX_LEAF_COUNT:
        assert tdata.k3[0].shape[0] == tdata.k3[1].shape[0] == 0
    else:
        for name, x in zip(("pw_tiles", "pl_tri_tiles"),
                           unpack_k3(*(t.numpy() for t in tdata.k3))):
            _assert_bit_equal(fields[name], x, name)
    for name, x in zip(("v0", "e1", "e2", "face"),
                       unpack_tri_records(tdata.tri_records)):
        _assert_bit_equal(fields[name], x.numpy(), name)
    for name, x in zip(_NODES, unpack_node_records(tdata.node_records)):
        _assert_bit_equal(fields[name], x.numpy(), name)
    for name in ("pl_remap", "sh_abc", "sh_slot"):
        _assert_bit_equal(fields[name], getattr(tdata, name).numpy(), name)
    _assert_bit_equal(np.asarray(fields["node_min"])[0], tdata.root_min,
                      "root_min")
    _assert_bit_equal(np.asarray(fields["node_max"])[0], tdata.root_max,
                      "root_max")
    assert tdata.pw_max_stack == wide_max_stack(np.asarray(fields["pw_entry"]))
    assert tdata.max_leaf == int(node_count.max())


def _assert_scene_equal(jdata, scene, tdata=None):
    """``scene.fields()`` equal the JAX SceneData's tables bit for bit, and
    the port's upload (``tdata``, else ``scene.send("cpu")``) gives them
    back."""
    jfields, fields = _jax_fields(jdata), scene.fields()
    for name in _SHARED:
        _assert_bit_equal(jfields[name], fields[name], name)
    jparts, parts = field_parts(jfields), field_parts(fields)
    assert len(parts) == len(jparts)
    for k, (jp, tp) in enumerate(zip(jparts, parts)):
        for name, ja, ta in zip(("node_rows", "tri_rows", "remap"), jp, tp):
            _assert_bit_equal(ja, ta, f"part {k} {name}")
    _assert_upload_equal(fields, scene.send("cpu") if tdata is None
                         else tdata)


def test_single_part_tables_bit_equal():
    jdata = JScene(_objects(JRect, JTriangles, 300)).send()
    scene = Scene(_objects(Rect, Triangles, 300))
    assert len(scene.send("cpu").k1_parts) == 1
    _assert_scene_equal(jdata, scene)


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
    scene = Scene(_objects(Rect, Triangles, 1200), max_leaf_tris=16)
    assert len(scene.send("cpu").k1_parts) >= 2
    _assert_scene_equal(jdata, scene)


@functools.lru_cache(maxsize=None)
def _subblock_inputs(name):
    """The (v0, v1, v2, tri16) the port's ``Scene`` hands the sub-block
    part builder: the small Cornell scene of ``test_torch_parts.py``
    (2,448 triangles) or this module's random soup (1,200 triangles and
    two rects)."""
    from test_torch_parts import cornell

    got = []
    orig = tscene_mod.build_subblock_parts
    tscene_mod.build_subblock_parts = lambda *a, **k: (
        got.append(a) or orig(*a, **k))
    try:
        if name == "cornell":
            cornell()
        else:
            Scene(_objects(Rect, Triangles, 1200)).fields()
    finally:
        tscene_mod.build_subblock_parts = orig
    return got[0]


KB = 1024
# (scene, budget, part cap, MAX_OCTETS, what the split gives)
PART_SPLITS = [
    ("cornell", 16 * KB, 16, None, 16),
    ("cornell", 64 * KB, 4, None, 4),
    ("cornell", 1 << 20, 4, None, 1),
    ("cornell", jwide2.TABLE_BUDGET_BYTES, 16, None, 1),
    ("cornell", 48 * KB, 4, None, "refused"),  # the built part, 56 KB
    ("cornell", 40 * KB, 4, None, "refused"),  # the least bytes, 44 KB
    ("cornell", 2 * KB, 16, None, "refused"),
    ("cornell", 1 << 20, 16, 64, 8),  # rounds 1-3 refused by the octets
    ("cornell", 1 << 20, 4, 64, "refused"),
    ("soup", 32 * KB, 16, None, 16),
    ("soup", 64 * KB, 4, None, 4),
    ("soup", 16 * KB, 4, None, "refused"),
]


@pytest.mark.parametrize("name,budget,max_parts,max_octets,expect",
                         PART_SPLITS)
def test_part_split_matches_the_jax_split(monkeypatch, name, budget,
                                          max_parts, max_octets, expect):
    """At any budget and part cap the port's ``build_subblock_parts``
    returns the JAX package's tables bit for bit, and raises where it
    raises, although it refuses a split on a part's least bytes or octets
    before building it; ``max_octets`` lowers both packages' octet cap."""
    if max_octets is not None:
        monkeypatch.setattr(twide2, "MAX_OCTETS", max_octets)
        monkeypatch.setattr(jwide2, "MAX_OCTETS", max_octets)
    args = _subblock_inputs(name)
    kw = dict(budget_bytes=budget, max_parts=max_parts)
    if expect == "refused":
        with pytest.raises(ValueError):
            jwide2.build_subblock_parts(*args, **kw)
        with pytest.raises(ValueError):
            twide2.build_subblock_parts(*args, **kw)
        return
    ref = jwide2.build_subblock_parts(*args, **kw)
    stats = {}
    got = twide2.build_subblock_parts(*args, **kw, stats=stats)
    assert len(got) == len(ref) == stats["parts"] == expect
    if max_octets is not None:
        assert stats["rounds"] == 4
    for k, (g, r) in enumerate(zip(got, ref)):
        for field in g._fields:
            if isinstance(getattr(r, field), np.ndarray):
                _assert_bit_equal(getattr(r, field), getattr(g, field),
                                  f"part {k} {field}")
            else:
                assert getattr(g, field) == getattr(r, field), (k, field)


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
    _assert_scene_equal(jdata, scene)
    if leaf == "no_bvh":
        assert scene.bvh is None
        assert scene.fields()["node_count"].tolist() == [
            scene.total_triangles]
    else:
        # the leaves' first octets, as Scene.fields lays the octets out
        counts = scene.bvh.node_count
        octets = -(-counts[counts > 0].astype(np.int64) // 8)
        first = np.zeros(len(counts), np.int32)
        first[counts > 0] = np.concatenate(([0], np.cumsum(octets)))[:-1]
        wide = collapse_wide(scene.bvh, first)
        validate_wide(wide, scene.bvh)
        np.testing.assert_array_equal(wide.entry, scene.fields()["pw_entry"])
        assert wide.max_stack == tdata.pw_max_stack


def test_scene_from_numpy_round_trip():
    """scene_from_numpy of the JAX SceneData's fields carries every table
    over unchanged: the upload gives them back bit for bit."""
    jfields = _jax_fields(JScene(_objects(JRect, JTriangles, 300)).send())
    _assert_upload_equal(jfields, scene_from_numpy(jfields, "cpu"))


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


def test_wait_for_jax_native_reloads_a_latched_failure(monkeypatch):
    """A worker whose JAX loader latched a failed load (``_lib`` None,
    ``_tried`` True) gets the library back from the helper."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build the JAX package's native library")
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    assert jnative.get_lib() is None  # latched: the loader never retries
    lib = wait_for_jax_native()
    assert lib is not None and jnative._lib is lib
    assert os.path.exists(NATIVE_LOCK)
    # the JAX side now builds its BVH natively: the port's tables equal it
    objs = _objects(JRect, JTriangles, 300)
    _assert_scene_equal(JScene(objs).send(),
                        Scene(_objects(Rect, Triangles, 300)))


def test_morton3d_and_ray_sort_keys_match_jax():
    """``morton3d`` on (..., 3) coordinates past 10 bits (the low 10 count)
    and the (R, 3) ``ray_sort_keys``, uint32 bit for bit."""
    from opengl_raytracer_tpu.ops.morton import morton3d as j_morton3d
    from opengl_raytracer_tpu.ops.morton import ray_sort_keys as j_rkeys
    from opengl_raytracer_torch.ops.morton import morton3d, ray_sort_keys

    g = np.random.default_rng(9)
    q = g.integers(0, 4096, (7, 300, 3)).astype(np.uint32)
    ref = np.asarray(j_morton3d(jnp.asarray(q))).astype(np.int64)
    np.testing.assert_array_equal(
        ref, morton3d(torch.from_numpy(q.astype(np.int64))).numpy())
    lo = np.asarray([-4.0, -2.5, -3.0], np.float32)
    hi = np.asarray([5.0, 3.5, 2.0], np.float32)
    o = g.uniform(-6, 6, (2000, 3)).astype(np.float32)
    d = g.normal(size=(2000, 3)).astype(np.float32)
    alive = g.uniform(size=2000) < 0.7
    ref = np.asarray(j_rkeys(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
                             jnp.asarray(hi), jnp.asarray(alive)))
    got = ray_sort_keys(torch.from_numpy(o), torch.from_numpy(d), lo, hi,
                        torch.from_numpy(alive))
    np.testing.assert_array_equal(ref.astype(np.int64), got.numpy())


def test_validate_bvh_passes_and_fails_as_jax():
    """The port's builder checker on the port's own BVH (native and NumPy
    builders) passes, as the JAX checker does; a leaf that loses its
    triangle fails both."""
    from opengl_raytracer_tpu.ops.bvh import validate_bvh as j_validate
    from opengl_raytracer_torch.ops.bvh import build_bvh, validate_bvh

    scene = Scene(_objects(Rect, Triangles, 300), max_leaf_tris=16)
    tris = (scene.v0, scene.v1, scene.v2)
    for native in (True, False):
        bvh = build_bvh(*tris, 16, prefer_native=native)
        for check in (validate_bvh, j_validate):
            check(bvh, *tris, 16)
    leaf = int(np.nonzero(bvh.node_count > 0)[0][0])
    perm = bvh.perm.copy()
    perm[bvh.node_first[leaf]] = perm[(bvh.node_first[leaf] + 1) % len(perm)]
    for check in (validate_bvh, j_validate):
        with pytest.raises(AssertionError):
            check(bvh._replace(perm=perm), *tris, 16)
        with pytest.raises(AssertionError):  # a leaf bound too small
            check(bvh, *tris, 1)


def test_validate_subblock_passes_and_fails_as_jax(monkeypatch):
    """The sub-block tables' checker on every part of the port's own
    tables (a scene split into several parts) passes, as the JAX checker
    does; an octet pushed twice fails both."""
    from opengl_raytracer_tpu.ops.wide2 import validate_subblock as j_validate
    from opengl_raytracer_torch.ops.wide2 import (EMPTY_PACKED, ORD0,
                                                  SubblockTables,
                                                  validate_subblock)

    orig = tscene_mod.build_subblock_parts
    monkeypatch.setattr(tscene_mod, "build_subblock_parts",
                        lambda *a, **k: orig(*a, budget_bytes=64 * 1024))
    scene = Scene(_objects(Rect, Triangles, 1200), max_leaf_tris=16)
    parts = field_parts(scene.fields())
    assert len(parts) > 1
    for nr, tr, rm in parts:
        tables = SubblockTables(nr, tr, rm, 0, 0, 0)
        validate_subblock(tables)
        j_validate(tables, scene.total_triangles)
    # the root pushes its first entry twice: its octets are reached twice
    rows = tables.node_rows.copy()
    lanes = rows[0, ORD0:ORD0 + 8]
    full = [k for k, p in enumerate(lanes) if p != EMPTY_PACKED * 8]
    empty = [k for k in range(8) if k not in full]
    rows[0, ORD0 + (empty or full)[-1]] = lanes[full[0]]
    bad = tables._replace(node_rows=rows)
    with pytest.raises(AssertionError):
        validate_subblock(bad)
    with pytest.raises(AssertionError):
        j_validate(bad, scene.total_triangles)


def test_send_keeps_one_upload_a_device_until_clear_memory():
    """``send`` hands out the same upload for a device, as the JAX
    ``send`` keeps its one; ``clearMemory`` drops it (the reference's
    scene.py:423) and the next ``send`` uploads equal tables again."""
    jscene = JScene(_objects(JRect, JTriangles, 300))
    scene = Scene(_objects(Rect, Triangles, 300))
    jdata, data = jscene.send(), scene.send("cpu")
    assert jscene.send() is jdata
    assert scene.send("cpu") is data
    assert scene.send(torch.device("cpu")) is data
    jscene.clearMemory()
    scene.clearMemory()
    again = scene.send("cpu")
    assert again is not data
    _assert_scene_equal(jscene.send(), scene, again)


@pytest.mark.parametrize("leaf", [4, 16, 32, "no_bvh"])
def test_resolve_leaf_bound_matches_jax(leaf):
    """The config with the scene's own largest leaf, whatever bound is
    asked for, as the JAX ``resolve_leaf_bound`` returns it, field for
    field."""
    import dataclasses

    from opengl_raytracer_tpu.renderer import resolve_leaf_bound as j_resolve
    from opengl_raytracer_tpu.utils.config import RenderConfig as JConfig
    from opengl_raytracer_torch.renderer import resolve_leaf_bound
    from opengl_raytracer_torch.utils.config import RenderConfig

    kw = (dict(build_bvh=False) if leaf == "no_bvh"
          else dict(max_leaf_tris=leaf))
    jdata = JScene(_objects(JRect, JTriangles, 300), **kw).send()
    data = Scene(_objects(Rect, Triangles, 300), **kw).send("cpu")
    for asked in (1, 64):
        cfg = dict(max_leaf_tris=asked, sort_every=2, width=64)
        ref = j_resolve(jdata, JConfig(**cfg))
        got = resolve_leaf_bound(data, RenderConfig(**cfg))
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    if leaf != "no_bvh":
        assert ref.max_leaf_tris <= leaf
