"""The port's traversals against the JAX package's, on the same tables
(``scene_from_numpy`` of the JAX SceneData's fields):

* K1's plain torch version and the part-chaining wrapper against
  ``raycast_subblock`` (interpret mode) and ``raycast_packet``;
* K3's plain torch version (``raycast_pallas``) against the JAX
  ``raycast_pallas`` in interpret mode, with axis-parallel rays whose
  origins lie on slab planes;
* ``raycast_brute`` (the sweep's plain version, ``_sweep_plain``) against
  the JAX ``raycast_brute`` and against the scalar oracle of
  tests/oracle.py, and ``raycast_bvh`` against the JAX ``raycast_bvh``;
  the records G7, G8 and G9 read give the tables back bit for bit;
* K1's Hopper tables (``SceneData.k1_parts``, ops/wide2.pack_k1): they
  decode back to the ``p2_*`` rows of ``Scene.fields()`` bit for bit, the
  JAX scene's carry over to the same tables as the port's own, and a
  scalar NumPy walk over them in the kernel's way (a stack of node
  groups, each child opened at its parent's visit with ``near <=
  best_t``) visits what the plain version counts and finds its hits
  exactly.

Tolerances:

* ``t`` within ``rtol=atol=1e-6``, widened per ray by the rounding bound
  of ``t = -(r.face)/det``: XLA contracts the dot products into FMAs and
  eager torch does not, and a ray starting next to a triangle's plane
  cancels ``r.face`` (4 ulps of ``sum|r_a face_a| / |det|``);
* the same hit set, and the hit triangle equal on every hit ray except
  where the port's triangle is hit at the same ``t`` (the JAX kernels
  order children by their packet's dominant octant, the port by the ray's
  own, so exact ties may resolve differently);
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
from opengl_raytracer_tpu.ops.intersect import raycast_brute as j_brute
from opengl_raytracer_tpu.ops.pallas_traversal import raycast_pallas as j_pallas
from opengl_raytracer_tpu.ops.subblock_traversal import raycast_subblock as j_subblock
from opengl_raytracer_tpu.ops.traversal import raycast_bvh as j_bvh
from opengl_raytracer_tpu.ops.traversal import raycast_packet as j_packet

import oracle
from opengl_raytracer_torch import Rect, Scene, Triangles, scene_from_numpy
from opengl_raytracer_torch.models import scene as scene_mod
from opengl_raytracer_torch.ops import pallas_traversal
from opengl_raytracer_torch.ops import subblock_traversal as sbt
from opengl_raytracer_torch.ops.intersect import (BIG, _sweep_plain,
                                                  raycast_brute,
                                                  unpack_tri_records)
from opengl_raytracer_torch.ops.subblock_traversal import (overflow_tensor,
                                                           raycast_subblock)
from opengl_raytracer_torch.ops.traversal import (raycast_bvh,
                                                  unpack_node_records)
from opengl_raytracer_torch.ops.wide2 import EMPTY_PACKED, pack_k1, unpack_k1
from test_torch_scene import field_parts
from test_torch_scene import jax_native  # noqa: F401 (autouse)
from torch_states import box_objects


def _fields(data):
    """np.asarray of every field of a JAX SceneData."""
    fields = {k: np.asarray(getattr(data, k)) for k in data._fields
              if k != "p2_extra"}
    fields["p2_extra"] = [tuple(np.asarray(x) for x in p)
                          for p in data.p2_extra]
    return fields


def _jax_scene(n_tris, budget=None, monkeypatch=None, leaf=16):
    if budget is not None:
        orig = jwide2.build_subblock_parts
        monkeypatch.setattr(jwide2, "build_subblock_parts",
                            lambda *a, **k: orig(*a, budget_bytes=budget))
    rng = np.random.default_rng(0)
    tris = rng.uniform(-3, 3, (n_tris, 3, 3)).astype(np.float32)
    objs = [JTriangles(tris, color=(0.5, 0.5, 0.5), roughness=1.0),
            # a box around the soup: shared quad edges give exact-t ties
            JRect([10, 10, 10], [0, 0, 0], [0, 0, 0], [0.8, 0.8, 0.8])]
    data = JScene(objs, max_leaf_tris=leaf).send()
    return data, scene_from_numpy(_fields(data), "cpu")


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


def _cols(x):
    return tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in x)


def _leaf(jdata):
    return int(np.asarray(jdata.node_count).max())


def _check(jdata, ref, got, o, d, active=None):
    rt, gt = np.asarray(ref.t), got.t.numpy()
    hit = rt < 1e29
    assert hit.sum() > len(rt) // 8
    np.testing.assert_array_equal(gt < 1e29, hit)  # the same hit set
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
    assert len(tdata.k1_parts) == (2 if parts == "multi" else 1)
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
    assert len(tdata.k1_parts) == (8 if parts == "multi" else 1)
    R = 4096
    o, d = _rays(R, seed=2)
    ref = j_packet(jdata, jnp.asarray(o.T), jnp.asarray(d.T),
                   max_leaf_tris=int(np.asarray(jdata.node_count).max()))
    got = _run_port(tdata, o, d)
    assert _check(jdata, ref, got, o, d) < R // 100


def _slab_plane_rays(fields, o, d, first=4, n=12):
    """Rays ``first..first+n``: axis-parallel, each with its origin on a
    slab plane of one of the root's child boxes (of the scene's tables
    ``fields``), inside the scene's bounds, so that box's slab test meets
    0 * inf = NaN and the child is not opened."""
    tiles = np.asarray(fields["pw_tiles"])
    lo0 = np.asarray(fields["node_min"])[0]
    hi0 = np.asarray(fields["node_max"])[0]
    planes = [(j, a, side) for j in range(8) for a in range(3)
              for side in (0, 3)
              if tiles[0, j, 0] <= tiles[0, j, 3]  # not an empty slot
              and lo0[a] < tiles[0, j, side + a] < hi0[a]]
    assert len(planes) >= n
    for k, (j, a, side) in enumerate(planes[:n]):
        b, c = (a + 1) % 3, (a + 2) % 3
        lo, hi = tiles[0, j, 0:3], tiles[0, j, 3:6]
        r = first + k
        o[:, r] = (lo + hi) * np.float32(0.5)
        o[a, r] = tiles[0, j, side + a]
        o[b, r] = lo[b] - np.float32(1.0)
        d[:, r] = 0.0
        d[b, r] = 1.0
        assert d[a, r] == 0.0 and d[c, r] == 0.0


@pytest.mark.parametrize("leaf", [8, 16])
def test_k3_plain_matches_jax_pallas(leaf):
    """K3's plain version against the JAX kernel in interpret mode, with
    an active mask, on tables carried over by scene_from_numpy."""
    jdata, tdata = _jax_scene(200, leaf=leaf)
    assert tdata.k3[1].shape[0] > 0
    R = 256
    o, d = _rays(R, seed=3)
    _slab_plane_rays(_fields(jdata), o, d)
    active = np.random.default_rng(8).uniform(size=R) < 0.8
    active[:16] = True
    ref = j_pallas(jdata, jnp.asarray(o.T), jnp.asarray(d.T),
                   jnp.asarray(active), max_leaf_tris=_leaf(jdata),
                   interpret=True)
    ov = pallas_traversal.overflow_tensor("cpu")
    ov.zero_()
    got = pallas_traversal.raycast_pallas(
        tdata, _cols(o), _cols(d), torch.from_numpy(active))
    assert int(ov.item()) == 0 and got.slot is None
    _check(jdata, ref, got, o, d, active)


def test_brute_matches_jax_brute():
    """The matmul sweep against the JAX one, over several 2048-triangle
    chunks, with an active mask; the box's shared quad edges make ties,
    which both resolve to the lowest index."""
    jdata, tdata = _jax_scene(5000)
    R = 512
    o, d = _rays(R, seed=4)
    active = np.random.default_rng(9).uniform(size=R) < 0.8
    ref = j_brute(jdata, jnp.asarray(o.T), jnp.asarray(d.T),
                  jnp.asarray(active))
    got = raycast_brute(tdata, _cols(o), _cols(d), torch.from_numpy(active))
    assert got.slot is None
    _check(jdata, ref, got, o, d, active)
    none = raycast_brute(tdata, _cols(o), _cols(d), torch.zeros(R, dtype=bool))
    assert (none.t == BIG).all()  # an all-dead batch skips the sweep


def test_brute_matches_oracle():
    """The port's brute force on its own Scene against the scalar GLSL
    oracle: the same hits, t within 1e-5 relative, the same material."""
    g = np.random.default_rng(6)
    tris = g.uniform(-3, 3, (60, 3, 3)).astype(np.float32)
    objs = [Triangles(tris, color=(0.2, 0.4, 0.6), roughness=0.5),
            Rect([10, 10, 10], [0, 0, 0], [0, 0, 0], [0.8, 0.7, 0.6])]
    scene = Scene(objs)
    data = scene.send("cpu")
    o, d = _rays(128, seed=5)
    got = raycast_brute(data, _cols(o), _cols(d))
    sc = oracle.OracleScene.from_scene(scene)
    color = data.sh_abc[got.tri.long()][:, 16:19].numpy()
    for r in range(o.shape[1]):
        ref = oracle.raycast(sc, o[:, r], d[:, r])
        gt = float(got.t[r])
        if ref is None:
            assert gt == BIG
            continue
        np.testing.assert_allclose(gt, ref["t"], rtol=1e-5)
        np.testing.assert_array_equal(color[r], ref["color"])


def test_bvh_matches_jax_bvh():
    """The stackless walk against the JAX one: the same nodes in the same
    order, so the same triangle wins every hit, ties included."""
    jdata, tdata = _jax_scene(257, leaf=8)
    R = 512
    o, d = _rays(R, seed=6)
    active = np.random.default_rng(10).uniform(size=R) < 0.8
    ref = j_bvh(jdata, jnp.asarray(o.T), jnp.asarray(d.T),
                jnp.asarray(active), max_leaf_tris=_leaf(jdata))
    got = raycast_bvh(tdata, _cols(o), _cols(d), torch.from_numpy(active),
                      max_leaf_tris=_leaf(jdata))
    assert _check(jdata, ref, got, o, d, active) == 0


@pytest.mark.parametrize("tri_chunk", [2048, 1024])
def test_sweep_plain_matches_jax_brute(tri_chunk):
    """The sweep kernel's plain version (written-out mul/add/sub, no
    matmul) against the JAX matmul sweep over 3 and 5 triangle chunks,
    with an active mask; a dead ray reports init_nearest's miss, an
    all-dead batch misses everywhere; its counts: every live pair tested,
    a candidate (whose u and v the kernel computes) at least every winner
    and at most every pair."""
    jdata, tdata = _jax_scene(5000)
    T = tdata.num_tris
    assert -(-T // tri_chunk) >= 3
    R = 512
    o, d = _rays(R, seed=11)
    active = np.random.default_rng(12).uniform(size=R) < 0.8
    ref = j_brute(jdata, jnp.asarray(o.T), jnp.asarray(d.T),
                  jnp.asarray(active))
    got, work = _sweep_plain(tdata, _cols(o), _cols(d),
                             torch.from_numpy(active), tri_chunk, counts=True)
    _check(jdata, ref, got, o, d, active)
    dead = torch.from_numpy(~active)
    assert not got.tri[dead].any() and not got.u[dead].any()
    assert not got.v[dead].any()
    live = torch.from_numpy(active)
    assert (work[0][live] == T).all() and not work[:, dead].any()
    hit = got.t < BIG
    assert (work[1][hit] >= 1).all() and (work[1] <= work[0]).all()
    same = _sweep_plain(tdata, _cols(o), _cols(d), torch.from_numpy(active),
                        2048)
    for a, b in zip(got[:4], same[:4]):
        assert torch.equal(a, b)  # the chunk does not change the result
    none = _sweep_plain(tdata, _cols(o), _cols(d), torch.zeros(R, dtype=bool),
                        tri_chunk)
    assert (none.t == BIG).all() and not none.tri.any()


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("kind,width", [("box", 8), ("soup", 8),
                                        ("no_bvh", 12)])
def test_records_round_trip(kind, width):
    """The node records of G7 and G9 and the triangle records of G7, G8
    and G9, packed at upload, give the scene's tables (``Scene.fields()``)
    back bit for bit: the box, a triangle soup, and a build_bvh=False
    scene, whose one leaf of 2,112 triangles does not fit the 32-byte
    record's 11-bit count and takes the 48-byte one."""
    g = np.random.default_rng(3)
    objs = {"box": box_objects,
            "soup": lambda: [Triangles(g.uniform(-3, 3, (500, 3, 3))
                                       .astype(np.float32))],
            "no_bvh": lambda: [Triangles(g.uniform(-3, 3, (2100, 3, 3))
                                         .astype(np.float32)),
                               Rect([1, 1, 1], [0, 0, 0], [0, 0, 0],
                                    [1, 1, 1])]}[kind]()
    scene = Scene(objs, build_bvh=kind != "no_bvh")
    data, fields = scene.send("cpu"), scene.fields()
    if kind == "box":
        assert scene.total_triangles == 84
    nodes, tris = data.node_records, data.tri_records
    assert nodes.dtype == torch.int32 and nodes.shape == (
        fields["node_miss"].shape[0], width)
    assert tris.shape == (data.num_tris, 12)
    assert data.max_leaf == int(fields["node_count"].max())
    names = ("node_min", "node_max", "node_miss", "node_first", "node_count")
    for name, x in zip(names, unpack_node_records(nodes)):
        ref = torch.from_numpy(np.ascontiguousarray(fields[name]))
        assert x.dtype == ref.dtype and x.shape == ref.shape, name
        assert torch.equal(_bits(x), _bits(ref)), name
    for name, x in zip(("v0", "e1", "e2", "face"), unpack_tri_records(tris)):
        ref = torch.from_numpy(np.ascontiguousarray(fields[name]))
        assert torch.equal(_bits(x), _bits(ref)), name


@pytest.mark.parametrize("traversal", ["brute", "bvh"])
def test_small_scene_frames_do_not_depend_on_the_chunk(traversal,
                                                       monkeypatch):
    """On the card "brute" and "bvh" take the kernels' 2M-ray chunk, so a
    1080p step is one chunk; on the CPU their plain versions take 128K.  A
    frame of the box is bit-equal in one chunk of all its rays and in the
    CPU's small chunks (the 128K bound cut to 512 here, so a small frame
    spans four, the last one padded): neither path reorders, and a ray's
    seed comes from its index."""
    from opengl_raytracer_torch import RenderConfig, Renderer, make_camera
    from opengl_raytracer_torch import renderer

    hd = 1920 * 1080
    cfg = RenderConfig(traversal=traversal)
    assert renderer.ray_chunk(cfg, hd, traversal, True) == hd
    assert renderer.ray_chunk(cfg, hd, traversal, False) == 128 * 1024
    assert renderer.ray_chunk(cfg, hd, "pallas2", False) == hd
    assert renderer.ray_chunk(RenderConfig(ray_chunk=1000), hd, traversal,
                              True) == 1024

    W, H = 48, 40  # R = 1,920 = 3 x 512 + 384
    images = []
    for chunk in (W * H, None):
        monkeypatch.setattr(renderer, "_SMALL_CHUNK", 512)
        r = Renderer(Scene(box_objects()), RenderConfig(
            width=W, height=H, bounces=4, traversal=traversal,
            ray_chunk=chunk), device="cpu")
        assert r.traversal == traversal
        cam = make_camera(np.array([0, 0, 20], np.float32), (180.0, 0.0))
        images.append(r.image(r.render(cam, frames=1)))
    assert float(images[0].mean()) > 0.01
    np.testing.assert_array_equal(images[0].view(np.int32),
                                  images[1].view(np.int32))


def test_k3_face_plane_rays_follow_per_ray_slab_test():
    """A ray lying in a face plane of the scene's bounding box meets a NaN
    slab at every box that shares the plane: the port's per-ray walk opens
    none of them and misses, as the JAX package's per-ray ``raycast_bvh``
    does.  (The JAX wide kernel shares node visits within a 1024-ray block,
    so there such a ray tests whatever leaves its block-mates open and may
    hit.)  Just off the plane, all three find the same hit."""
    jdata, tdata = _jax_scene(200, leaf=8)
    lo0 = np.asarray(jdata.node_min)[0]
    R = 128
    o, d = _rays(R, seed=11)
    o[:, :2] = np.asarray([[0.0, lo0[1], lo0[2] - 1.0],
                           [0.0, lo0[1] + np.float32(1e-3), lo0[2] - 1.0]],
                          np.float32).T
    d[:, :2] = np.asarray([[0.0, 0.0, 1.0]] * 2, np.float32).T
    got = pallas_traversal.raycast_pallas(tdata, _cols(o), _cols(d))
    ref = j_bvh(jdata, jnp.asarray(o.T), jnp.asarray(d.T),
                max_leaf_tris=_leaf(jdata))
    assert float(got.t[0]) == BIG and float(ref.t[0]) == BIG
    assert float(got.t[1]) < BIG
    np.testing.assert_allclose(float(got.t[1]), float(ref.t[1]), rtol=1e-6)
    _check(jdata, ref, got, o, d)


def _port_scene(n_tris, budget=None, monkeypatch=None, leaf=16):
    """The port's own Scene of _jax_scene's objects."""
    if budget is not None:
        orig = scene_mod.build_subblock_parts
        monkeypatch.setattr(scene_mod, "build_subblock_parts",
                            lambda *a, **k: orig(*a, budget_bytes=budget))
    rng = np.random.default_rng(0)
    tris = rng.uniform(-3, 3, (n_tris, 3, 3)).astype(np.float32)
    objs = [Triangles(tris, color=(0.5, 0.5, 0.5), roughness=1.0),
            Rect([10, 10, 10], [0, 0, 0], [0, 0, 0], [0.8, 0.8, 0.8])]
    return Scene(objs, max_leaf_tris=leaf)


_PARTS = {"single": (257, None, 1), "multi": (600, 96 * 1024, 2)}


@pytest.mark.parametrize("parts", ["single", "multi"])
def test_k1_tables_decode_to_rows(parts, monkeypatch):
    """Every part's Hopper tables give its rows (``Scene.fields()``) back
    bit for bit, order lanes included, with its remap; each octant's order
    word is a permutation of the 8 slots; rows whose order lanes are not a
    permutation are refused."""
    n, budget, n_parts = _PARTS[parts]
    scene = _port_scene(n, budget, monkeypatch)
    data, rows_of = scene.send("cpu"), field_parts(scene.fields())
    assert len(data.k1_parts) == len(rows_of) == n_parts
    for (node_rows, tri_rows, remap), (nodes, octets, k1_remap) in zip(
            rows_of, data.k1_parts):
        assert nodes.dtype == torch.int32 and octets.dtype == torch.float32
        assert tuple(nodes.shape) == (node_rows.shape[0], 64)
        assert tuple(octets.shape) == (tri_rows.shape[0], 96)
        rows, tris = unpack_k1(nodes.numpy(), octets.numpy())
        np.testing.assert_array_equal(rows.view(np.int32),
                                      node_rows.view(np.int32))
        np.testing.assert_array_equal(tris.view(np.int32),
                                      tri_rows.view(np.int32))
        np.testing.assert_array_equal(k1_remap.numpy(), remap)
        word = nodes.numpy()[:, 56:].astype(np.int64)
        slots = (word[:, :, None] >> (3 * np.arange(8))) & 7
        assert (np.sort(slots, axis=2) == np.arange(8)).all()
        assert (word >> 24 == 0).all()
    bad = rows_of[0][0].copy()
    lanes = bad[0, 48:56]  # octant 0 of the root: a slot named twice
    lanes[lanes != EMPTY_PACKED * 8] = lanes[lanes != EMPTY_PACKED * 8][0]
    with pytest.raises(ValueError):
        pack_k1(bad, rows_of[0][1])


@pytest.mark.parametrize("parts", ["single", "multi"])
def test_k1_tables_from_jax_scene_match_port(parts, monkeypatch):
    """scene_from_numpy of the JAX scene's fields packs the same Hopper
    tables as the port's own Scene of the same objects."""
    n, budget, n_parts = _PARTS[parts]
    _, tdata = _jax_scene(n, budget, monkeypatch)
    port = _port_scene(n, budget, monkeypatch).send("cpu")
    assert len(tdata.k1_parts) == len(port.k1_parts) == n_parts
    for a, b in zip(tdata.k1_parts, port.k1_parts):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)


def _scalar_walk(nodes, octets, o, d, t0):
    """One ray's walk as csrc/subblock_traversal.cu does it, in NumPy
    float32 scalars over the Hopper tables: a stack of node groups (a node
    and the mask of its children still to visit, by near-first rank in the
    ray's octant), each child opened by the slab test with ``near <=
    best_t`` when its parent is visited, the strict ``<`` update.  Returns
    (t, slot, u, v, node visits, octets tested, triangles whose t beat the
    best hit)."""
    f32 = np.float32
    bt, slot, bu, bv = f32(t0), 0, f32(0), f32(0)
    if not bt > -BIG:
        return bt, slot, bu, bv, 0, 0, 0
    with np.errstate(divide="ignore"):
        inv = [np.clip(f32(1) / d[a], f32(-1e18), f32(1e18)) for a in range(3)]
    with np.errstate(over="ignore"):  # empty slots' +-1e30 bounds
        return _walk(nodes, octets, o, d, inv, bt, slot, bu, bv)


def _walk(nodes, octets, o, d, inv, bt, slot, bu, bv):
    f32 = np.float32
    oi = [o[a] * inv[a] for a in range(3)]
    octant = (int(d[0] < 0) << 2) | (int(d[1] < 0) << 1) | int(d[2] < 0)
    boxes = np.ascontiguousarray(nodes[:, :48]).view(np.float32)
    groups, cur, visits, tested, cands = [], 0, 0, 0, 0
    while True:
        if cur >= 0:
            visits += 1
            b = boxes[cur].reshape(6, 8)
            hit = 0
            for j in range(8):
                t1 = [b[a, j] * inv[a] - oi[a] for a in range(3)]
                t2 = [b[3 + a, j] * inv[a] - oi[a] for a in range(3)]
                near = max(max(min(t1[0], t2[0]), min(t1[1], t2[1])),
                           min(t1[2], t2[2]))
                far = min(min(max(t1[0], t2[0]), max(t1[1], t2[1])),
                          max(t1[2], t2[2]))
                if (far >= near and far >= 0 and near <= bt
                        and nodes[cur, 48 + j] != EMPTY_PACKED):
                    hit |= 1 << j
            word = int(nodes[cur, 56 + octant])
            mask = sum(1 << r for r in range(8)
                       if hit >> ((word >> (3 * r)) & 7) & 1)
            if mask:
                groups.append((cur, mask))
        else:
            tested += 1
            q = -cur - 1
            for j in range(8):
                c = octets[q, 12 * j:12 * j + 12]
                v0, fc, e1, e2 = c[0:3], c[3:6], c[6:9], c[9:12]
                det = d[0] * fc[0] + d[1] * fc[1] + d[2] * fc[2]
                with np.errstate(divide="ignore", invalid="ignore"):
                    inv_det = f32(1) / det
                    r = [o[a] - v0[a] for a in range(3)]
                    t = -(r[0] * fc[0] + r[1] * fc[1] + r[2] * fc[2]) * inv_det
                    p = [r[1] * d[2] - r[2] * d[1], r[2] * d[0] - r[0] * d[2],
                         r[0] * d[1] - r[1] * d[0]]
                    u = -(e2[0] * p[0] + e2[1] * p[1] + e2[2] * p[2]) * inv_det
                    v = (e1[0] * p[0] + e1[1] * p[1] + e1[2] * p[2]) * inv_det
                cands += bool(abs(det) >= f32(1e-6) and f32(1e-6) < t < bt)
                valid = (abs(det) >= f32(1e-6) and t > f32(1e-6) and u >= 0
                         and v >= 0 and u + v <= 1)
                if valid and t < bt:
                    bt, slot, bu, bv = t, q * 8 + j, u, v
        if not groups:
            return bt, slot, bu, bv, visits, tested, cands
        w, mask = groups.pop()
        rank = (mask & -mask).bit_length() - 1
        cur = int(nodes[w, 48 + ((int(nodes[w, 56 + octant]) >> (3 * rank))
                                 & 7)])
        if mask & (mask - 1):
            groups.append((w, mask & (mask - 1)))


def test_plain_counts_match_scalar_walk():
    """The plain version's per-ray node visits, leaf octets, steps and
    barycentric tests equal those of the kernel's walk written as scalar NumPy over the
    Hopper tables, and so do t, slot, u and v, bit for bit."""
    data = _port_scene(2000).send("cpu")
    nodes, octets, _ = data.k1_parts[0]
    R = 48
    o, d = _rays(R, seed=12)
    t0 = np.full(R, BIG, np.float32)
    t0[[5, 17]] = -BIG  # dead rays
    t0[9] = np.float32(2.5)  # a later part's entry: prunes against it
    *got, dropped, counts = sbt._traverse_plain(
        nodes, octets, _cols(o), _cols(d), torch.from_numpy(t0),
        counts=True)
    assert int(dropped) == 0
    nodes, octets = nodes.numpy(), octets.numpy()
    for r in range(R):
        t, slot, u, v, visits, tested, cands = _scalar_walk(
            nodes, octets, o[:, r], d[:, r], t0[r])
        assert tuple(int(c) for c in counts[:, r]) \
            == (visits, tested, visits + tested, cands), r
        assert (float(got[0][r]), int(got[1][r]), float(got[2][r]),
                float(got[3][r])) == (float(t), slot, float(u), float(v)), r
    assert int(counts[0].max()) > 3 and int(counts[1].sum()) > R


@pytest.mark.parametrize("parts", ["single", "multi"])
def test_counting_leaves_hits_unchanged(parts, monkeypatch):
    """The plain version with per-ray counts returns the same t, slot, u
    and v as without, and the part chain run through it still agrees with
    the JAX kernel in interpret mode."""
    n, budget, n_parts = _PARTS[parts]
    jdata, tdata = _jax_scene(n, budget, monkeypatch)
    R = 256
    o, d = _rays(R, seed=13)
    t0 = torch.full((R,), BIG)
    for nodes, octets, _ in tdata.k1_parts:
        plain = sbt._traverse_plain(nodes, octets, _cols(o), _cols(d), t0)
        counted = sbt._traverse_plain(nodes, octets, _cols(o), _cols(d), t0,
                                      counts=True)
        assert len(counted) == 6 and counted[5].shape == (4, R)
        for a, b in zip(plain, counted[:5]):
            assert torch.equal(a, b)
    plain_fn = sbt._traverse_plain
    monkeypatch.setattr(sbt, "_traverse_plain",
                        lambda *a: plain_fn(*a, counts=True)[:5])
    active = np.random.default_rng(14).uniform(size=R) < 0.7
    ref = j_subblock(jdata, tuple(jnp.asarray(x) for x in o),
                     tuple(jnp.asarray(x) for x in d), jnp.asarray(active),
                     interpret=True)
    got = _run_port(tdata, o, d, active)
    assert len(tdata.k1_parts) == n_parts
    _check(jdata, ref, got, o, d, active)
