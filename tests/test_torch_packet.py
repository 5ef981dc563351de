"""The port's packet traversal (``"packet"``) against the JAX package's.

* ``traversal._packet_plain`` (G9's plain version) against the JAX
  ``raycast_packet`` on the same tables (``scene_from_numpy`` of the JAX
  SceneData's fields), with dead rays, a packet of dead rays only, rays in
  face planes of BVH boxes (NaN slab values) and rays aimed at shared quad
  edges (ties), on a scene whose tree is one leaf and on one of many
  leaves; and its work counts against a scalar NumPy walk of each packet;
* the 8x16 block order: ``front.band_pixels`` and ``fold.fold_plain``
  against the pixel list the JAX tile step hands its ``render_flat`` and
  the image it folds back (integers, so exactly), blocked at
  frames_per_step 1 and 2 and not blocked on a tile that is no whole
  number of blocks;
* frames of the port's ``Renderer`` under ``"packet"`` against the JAX
  ``Renderer``'s, blocked (16x16, 32x16 at frames_per_step 2) and not
  blocked (24x20 at tile_size 5), at ``tests/test_torch_render.py``'s
  tolerance; the reorders of a blocked step carry the seed, of a
  row-major one rebuild it.

Tolerances: those of ``tests/test_torch_traversal.py:_check`` (the same
hit set; t within 1e-6 widened by the rounding of ``r.face / det``, as
XLA contracts the dot products into FMAs and eager torch does not; a
different triangle only where the port's is hit at the reference's t)
and of ``tests/test_torch_render.py:_assert_matches``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import opengl_raytracer_tpu.renderer as jrenderer
from opengl_raytracer_tpu.models.rect import Rect as JRect
from opengl_raytracer_tpu.models.scene import Scene as JScene
from opengl_raytracer_tpu.models.trisoup import Triangles as JTriangles
from opengl_raytracer_tpu.ops.camera import make_camera as j_make_camera
from opengl_raytracer_tpu.ops.intersect import mt_single as j_mt
from opengl_raytracer_tpu.ops.traversal import raycast_packet as j_packet
from opengl_raytracer_tpu.renderer import Renderer as JRenderer
from opengl_raytracer_tpu.utils.config import RenderConfig as JRenderConfig

from opengl_raytracer_torch import (Rect, RenderConfig, Renderer, Scene,
                                    Triangles, make_camera, scene_from_numpy)
from opengl_raytracer_torch import renderer
from opengl_raytracer_torch.ops import front, fold, permute, step_block
from opengl_raytracer_torch.ops.intersect import BIG
from opengl_raytracer_torch.ops.traversal import (PACKET, _packet_plain,
                                                  _walk_plain, raycast_packet)
from test_torch_render import CAM, _assert_matches, _objects
from test_torch_scene import jax_native  # noqa: F401 (autouse)
from test_torch_traversal import _check, _fields, _rays


def _scene(n_tris, leaf, build_bvh=True):
    rng = np.random.default_rng(3)
    tris = rng.uniform(-3, 3, (n_tris, 3, 3)).astype(np.float32)
    objs = [JTriangles(tris, color=(0.5, 0.5, 0.5), roughness=1.0),
            # a box around the soup: shared quad edges give exact-t ties
            JRect([10, 10, 10], [0, 0, 0], [0, 0, 0], [0.8, 0.8, 0.8])]
    data = JScene(objs, max_leaf_tris=leaf, build_bvh=build_bvh).send()
    return data, scene_from_numpy(_fields(data), "cpu")


def _tables(jdata):
    """The binary BVH's five node arrays and the four triangle arrays of
    a JAX SceneData, as NumPy arrays (the scalar walk's tables)."""
    return ([np.asarray(getattr(jdata, k)) for k in (
        "node_min", "node_max", "node_miss", "node_first", "node_count")],
            [np.asarray(getattr(jdata, k)) for k in ("v0", "e1", "e2",
                                                    "face")])


def _odd_rays(jdata, R, seed):
    """Random rays with axis-parallel ones, rays in face planes of the
    root's and of an inner node's box, rays aimed at shared edges of the
    enclosing box's triangles, dead rays and a packet (the third) whose
    rays are all dead.

    The shared-edge rays start at integer points inside the box and head
    (unnormalized) for the centre of one of its faces (the midpoint of the
    diagonal that the face's two triangles share) or the midpoint of one
    of its edges (where two faces meet at the same t).  Their products are
    exact integers, so both programs round alike (one division, one
    product) and a ray on an edge falls into no crack in one and not the
    other; its tie between two triangles is a true one."""
    o, d = _rays(R, seed)
    g = np.random.default_rng(seed + 1)
    lo, hi = np.asarray(jdata.node_min), np.asarray(jdata.node_max)
    for k, node in enumerate((0, 0, 0, min(1, len(lo) - 1))):
        a, b = k % 3, (k + 1) % 3
        r = 8 + k
        o[:, r] = (lo[node] + hi[node]) * np.float32(0.5)
        o[a, r] = lo[node, a]  # in the box's face plane
        o[b, r] = lo[node, b] - np.float32(1.0)
        d[:, r] = 0.0
        d[b, r] = 1.0
    axes = np.eye(3, dtype=np.float32)
    faces = [s * 5 * axes[a] for a in range(3) for s in (-1, 1)]
    edges = [s * 5 * axes[a] + t * 5 * axes[(a + 1) % 3] for a in range(3)
             for s in (-1, 1) for t in (-1, 1)]
    targets = np.stack(faces + edges, axis=1)
    o[:, 20:120] = g.integers(-4, 5, (3, 100))
    d[:, 20:120] = targets[:, g.integers(0, targets.shape[1], 100)] \
        - o[:, 20:120]
    active = g.uniform(size=R) < 0.8
    active[2 * PACKET:3 * PACKET] = False
    return o, d, active


def _cols(x):
    return tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in x)


@pytest.mark.parametrize("n_tris,leaf", [(4, 16), (600, 8)],
                         ids=["one_leaf", "many_leaves"])
@pytest.mark.parametrize("masked", [True, False])
def test_packet_plain_matches_jax(n_tris, leaf, masked):
    jdata, tdata = _scene(n_tris, leaf)
    assert (tdata.node_records.shape[0] == 1) == (n_tris == 4)
    R = 8 * PACKET
    o, d, active = _odd_rays(jdata, R, seed=5)
    act = active if masked else None
    max_leaf = int(np.asarray(jdata.node_count).max())
    ref = j_packet(jdata, jnp.asarray(o.T), jnp.asarray(d.T),
                   None if act is None else jnp.asarray(act),
                   max_leaf_tris=max_leaf)
    got = raycast_packet(tdata, _cols(o), _cols(d),
                         None if act is None else torch.from_numpy(act),
                         max_leaf)
    assert _check(jdata, ref, got, o, d, act) < R // 100
    if masked:
        dead = ~active
        assert (got.tri.numpy()[dead] == 0).all()
        assert (got.u.numpy()[dead] == 0).all()


def _scalar_packet(nodes, tris, o, d, live, max_leaf):
    """One packet's walk in NumPy float32, the kernel's loop over its
    nodes in the plain version's operation order: (visits, slots tested,
    each ray's candidates)."""
    lo, hi, miss, first, count = nodes
    v0, e1, e2, face = tris
    N = len(miss)
    bt = np.where(live, np.float32(BIG), np.float32(-BIG))
    node = 0 if live.any() else N
    visits = slots = 0
    cands = np.zeros(len(live), np.int64)
    with np.errstate(all="ignore"):
        inv = np.float32(1.0) / d
        while node < N:
            visits += 1
            t1 = (lo[node][:, None] - o) * inv
            t2 = (hi[node][:, None] - o) * inv
            near = np.minimum(t1, t2).max(axis=0)
            far = np.maximum(t1, t2).min(axis=0)
            enter = (far >= near) & (far >= 0) & (np.maximum(near, 0) <= bt)
            if enter.any() and count[node] > 0:
                for tri in range(first[node],
                                 first[node] + min(count[node], max_leaf)):
                    slots += 1
                    det = (d * face[tri][:, None]).sum(axis=0)
                    inv_det = np.float32(1.0) / det
                    r = o - v0[tri][:, None]
                    t = -(r * face[tri][:, None]).sum(axis=0) * inv_det
                    p = np.cross(r, d, axis=0)
                    u = -(e2[tri][:, None] * p).sum(axis=0) * inv_det
                    v = (e1[tri][:, None] * p).sum(axis=0) * inv_det
                    cand = (np.abs(det) >= 1e-6) & (t > 1e-6) & (t < bt)
                    cands += cand
                    ok = cand & (u >= 0) & (v >= 0) & (u + v <= 1)
                    bt = np.where(ok, t, bt)
                node = miss[node]
            else:
                node = node + 1 if enter.any() else miss[node]
    return visits, slots, cands


def test_packet_counts_match_scalar_walk():
    """The plain version's work (a packet's node visits and slot tests, a
    ray's candidates), which prices G9's bound, equals a scalar NumPy walk
    of each packet; its hits are the uncounted run's.  A dead packet does
    no work.  The per-ray walk finds the same nearest t wherever a ray's
    slab tests are conservative."""
    jdata, tdata = _scene(300, 8)
    R = 4 * PACKET
    o, d, active = _odd_rays(jdata, R, seed=9)
    act = torch.from_numpy(active)
    leaf = tdata.max_leaf
    near, work = _packet_plain(tdata, _cols(o), _cols(d), act, leaf,
                               counts=True)
    plain = _packet_plain(tdata, _cols(o), _cols(d), act, leaf)
    for a, b in zip(near[:4], plain[:4]):
        assert torch.equal(a, b)
    nodes, tris = _tables(jdata)
    for p in range(R // PACKET):
        s = slice(p * PACKET, (p + 1) * PACKET)
        visits, slots, cands = _scalar_packet(nodes, tris, o[:, s], d[:, s],
                                              active[s], leaf)
        assert int(work.visits[p]) == visits
        assert int(work.slots[p]) == slots
        np.testing.assert_array_equal(work.candidates[s].numpy(), cands)
    assert int(work.visits[2]) == int(work.slots[2]) == 0
    assert not work.candidates[~act].any()
    # the per-ray walk finds the same nearest t, but for the rays in face
    # planes (8-11): their own slab tests open nothing (NaN), so alone
    # they miss, while their packets' other rays open the boxes for them
    walk = _walk_plain(tdata, _cols(o), _cols(d), act, leaf).t
    same = torch.ones(R, dtype=torch.bool)
    same[8:12] = False
    assert torch.equal(walk[same], near.t[same])
    assert (walk[8:12] == BIG).all() and (near.t[8:12] < BIG).all()


@pytest.mark.parametrize("n_tris,leaf,build_bvh",
                         [(300, 32, False), (600, 512, True)],
                         ids=["unbuilt", "two_large_leaves"])
def test_packet_large_leaves(n_tris, leaf, build_bvh):
    """Leaves of more triangles than a packet has rays (G9 stages such a
    leaf's records 128 at a time, the last chunk partial): one leaf of all
    312 triangles (``build_bvh=False``), and two SAH leaves of 305 and 307
    under ``max_leaf_tris=512``; dead rays and a packet with none.  The
    plain version's work equals the scalar NumPy walk's and its hits the
    per-ray walk's (but for the face-plane rays 8-11); over the one leaf,
    which every live ray's packet opens, its hits are the JAX package's
    ``mt_single`` over all triangles in order with a strict <, the JAX
    packet walk's arithmetic.  (That walk unrolls a leaf's slots, too many
    here to compile on the CPU in a test's time.)"""
    jdata, tdata = _scene(n_tris, leaf, build_bvh)
    counts = np.asarray(jdata.node_count)
    counts = counts[counts > 0]
    assert len(counts) == (1 if not build_bvh else 2)
    assert (counts > 2 * PACKET).all() and (counts % PACKET > 0).all()
    R = 8 * PACKET
    o, d, active = _odd_rays(jdata, R, seed=7)
    act = torch.from_numpy(active)
    max_leaf = int(counts.max())
    near, work = _packet_plain(tdata, _cols(o), _cols(d), act, max_leaf,
                               counts=True)
    got = raycast_packet(tdata, _cols(o), _cols(d), act, max_leaf)
    for x, y in zip(near[:4], got[:4]):
        assert torch.equal(x, y)
    assert (got.t[~act] == BIG).all() and not got.tri[~act].any()
    nodes, tris = _tables(jdata)
    for p in range(R // PACKET):
        s = slice(p * PACKET, (p + 1) * PACKET)
        visits, slots, cands = _scalar_packet(nodes, tris, o[:, s], d[:, s],
                                              active[s], max_leaf)
        assert int(work.visits[p]) == visits
        assert int(work.slots[p]) == slots
        np.testing.assert_array_equal(work.candidates[s].numpy(), cands)
    assert int(work.slots[2]) == 0
    assert int(work.slots.max()) == int(counts.sum())  # every leaf opened
    walk = _walk_plain(tdata, _cols(o), _cols(d), act, max_leaf).t
    same = torch.ones(R, dtype=torch.bool)
    same[8:12] = False
    assert torch.equal(walk[same], got.t[same])
    if not build_bvh:
        ok, t, u, v = j_mt(*(jnp.asarray(x.T)[:, None] for x in (o, d)),
                           *(jnp.asarray(x)[None] for x in (
                               jdata.v0, jdata.e1, jdata.e2, jdata.face)))
        ts = jnp.where(ok & jnp.asarray(active)[:, None], t, BIG)
        arg = jnp.argmin(ts, axis=1)  # the first of equal t wins
        ref = SimpleNamespace(t=ts.min(1), tri=arg,
                              u=jnp.take_along_axis(u, arg[:, None], 1)[:, 0],
                              v=jnp.take_along_axis(v, arg[:, None], 1)[:, 0])
        assert _check(jdata, ref, got, o, d, active) == 0


def test_packet_refuses_partial_packets():
    _, tdata = _scene(40, 8)
    o, d = _rays(200)
    with pytest.raises(ValueError, match="multiple of packet 128"):
        raycast_packet(tdata, _cols(o), _cols(d))


def _jax_step_pixels(monkeypatch, width, height, tile_size, F):
    """The pixel list (px, py, frame numbers) that the JAX tile step hands
    its render_flat under "packet" for the last tile of the top band row
    at frame 0, and the accum it folds back when each ray's colour is its
    own (px, py, frame): the to_blocks permutation and its inverse."""
    seen = {}

    def fake(scene, config, camera, frame_count, sky, jit, lam, px, py,
             raycast_fn, traversal, recon=None):
        R = px.shape[0]
        frames = jnp.broadcast_to(jnp.asarray(frame_count, jnp.int32), (R,))
        seen.update(px=np.asarray(px), py=np.asarray(py),
                    frame=np.asarray(frames), recon=recon)
        return jnp.stack([px, py, frames], axis=1).astype(jnp.float32)

    monkeypatch.setattr(jrenderer, "render_flat", fake)
    cfg = JRenderConfig(width=width, height=height, tile_size=tile_size,
                        frames_per_step=F, traversal="packet")
    jdata = JScene(_objects(JRect, JTriangles)).send()
    accum = jnp.zeros((height, width, 3), jnp.float32)
    out = jrenderer._tile_step(
        jdata, j_make_camera(*CAM), accum, jnp.int32(0),
        jnp.int32(cfg.num_tiles_x - 1), jnp.int32(0), 1.0, 0.0, True,
        config=cfg, traversal="packet")
    monkeypatch.undo()
    return seen, np.asarray(out)


@pytest.mark.parametrize("width,height,tile_size,F,blocked", [
    (32, 16, 1, 1, True), (64, 32, 2, 2, True), (24, 20, 5, 1, False)],
    ids=["blocks", "blocks_fps2_tiles", "rows_tile_size_5"])
def test_block_order_matches_jax(monkeypatch, width, height, tile_size, F,
                                 blocked):
    """G1's pixel rule (``band_pixels``) and G6's fold (``fold_plain``) in
    the port's block mode equal the JAX step's to_blocks order and its
    inverse exactly: the last tile of a frame's first band row, ``F``
    copies of the band; each pixel gets its own coordinates back."""
    seen, ref_accum = _jax_step_pixels(monkeypatch, width, height,
                                       tile_size, F)
    cfg = RenderConfig(width=width, height=height, tile_size=tile_size,
                       frames_per_step=F, traversal="packet")
    assert renderer.packet_blocks(cfg, "packet") == blocked
    assert (seen["recon"] is None) == blocked
    tw, th = cfg.tile_w, cfg.tile_h
    n_band = tw * th
    tx = cfg.num_tiles_x - 1
    col0, py0, _, _ = renderer.band_window(cfg, tx, 0)
    px, py, frames = front.band_pixels(col0, py0, 0, 0, F * n_band,
                                       F * n_band, n_band, tw, "cpu",
                                       blocks=blocked)
    np.testing.assert_array_equal(px.numpy(), seen["px"])
    np.testing.assert_array_equal(py.numpy(), seen["py"])
    np.testing.assert_array_equal(frames.numpy(), seen["frame"])
    block = step_block.new("cpu")
    cam = make_camera(*CAM)
    accum = torch.zeros((height, width, 3))
    step_block.write(block, renderer.step_words(cfg, 0, tx, 0, cam, 1.0, 0.0,
                                                True, accum))
    colors = tuple(x.to(torch.float32) for x in (px, py, frames))
    fold.fold_band(accum, colors, block, tw, th, F, F, blocked)
    np.testing.assert_array_equal(accum.numpy(), ref_accum)
    # every pixel of the tile holds its own coordinates
    rows = height - py0 - th
    band = accum.numpy()[rows:rows + th, col0:col0 + tw]
    xs, ys = np.meshgrid(col0 + np.arange(tw), py0 + np.arange(th)[::-1])
    np.testing.assert_array_equal(band[..., 0], xs)
    np.testing.assert_array_equal(band[..., 1], ys)


def test_band_pixels_blocks_permute_the_band():
    """Each copy of a blocked band holds every pixel once, each 128-ray
    packet an 8x16 block of them; the wrappers refuse a band that is no
    whole number of blocks."""
    tw, th = 48, 16
    px, py, frames = front.band_pixels(0, 0, 3, 0, 2 * tw * th, 2 * tw * th,
                                       tw * th, tw, "cpu", blocks=True)
    for c in range(2):
        s = slice(c * tw * th, (c + 1) * tw * th)
        assert sorted((py[s] * tw + px[s]).tolist()) == list(range(tw * th))
        assert (frames[s] == 3 + c).all()
    for p in range(2 * tw * th // PACKET):
        s = slice(p * PACKET, (p + 1) * PACKET)
        assert px[s].max() - px[s].min() == 15
        assert py[s].max() - py[s].min() == 7
    with pytest.raises(ValueError, match="8x16 blocks"):
        front.check_band(24 * 16, 24, True)
    with pytest.raises(ValueError, match="8x16 blocks"):
        fold.fold_band(torch.zeros((12, 16, 3)), (torch.zeros(192),) * 3,
                       step_block.new("cpu"), 16, 12, 1, 1, True)


def _spy_recon(monkeypatch):
    seen = []
    reorder = permute.reorder

    def spy(*args):
        seen.append(args[9] is not None)
        return reorder(*args)

    monkeypatch.setattr(permute, "reorder", spy)
    return seen


@pytest.mark.parametrize("cfg,blocked", [
    (dict(width=16, height=16), True),
    (dict(width=32, height=16, frames_per_step=2), True),
    (dict(width=24, height=20, tile_size=5), False)],
    ids=["16x16", "32x16_fps2", "24x20_tile_size_5"])
def test_renderer_packet_matches_jax(monkeypatch, cfg, blocked):
    """A frame of the port under "packet" (G9's plain version, the rays in
    8x16 blocks where the tile allows) against the JAX Renderer's; the
    blocked steps' reorders carry the seed and the row-major ones rebuild
    it, as the JAX step's recon is off only for blocks."""
    cfg = dict(dict(bounces=2, traversal="packet"), **cfg)
    frames = cfg.get("frames_per_step", 1) * 2
    jr = JRenderer(JScene(_objects(JRect, JTriangles)), JRenderConfig(**cfg))
    ref = jr.image(jr.render(camera=j_make_camera(*CAM), frames=frames))
    seen = _spy_recon(monkeypatch)
    r = Renderer(Scene(_objects(Rect, Triangles)), RenderConfig(**cfg),
                 device="cpu")
    assert r.traversal == "packet"
    assert renderer.packet_blocks(r.config, "packet") == blocked
    got = r.image(r.render(make_camera(*CAM), frames=frames))
    assert seen and set(seen) == {not blocked}
    _assert_matches(ref, got)
