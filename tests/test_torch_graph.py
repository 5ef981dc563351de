"""The port's compiled step, on the CPU: the step block, the plain versions
of G5 (K3's wrapper prologue and epilogue) and G6 (the band fold), and a
step body that reads every per-step value from its block.

* The block's words round-trip (``step_block.pack`` / ``values``), frame
  numbers past 2^32 and the accumulation's address included.
* G5: ``raycast_pallas`` equals its former inline code bit for bit, on a
  scene's own K3 output, with and without an active mask.
* G6: ``fold_plain`` against the JAX ``_tile_step``'s merge
  (``opengl_raytracer_tpu/renderer.py:367-391``, its ``render_flat``
  replaced by the same colours): remainder tiles (``tile_size`` 3 on
  24x20), ``frames_per_step`` 2, frame counts near 2^24 and 2^32.
  Tolerance: XLA may contract ``prev * fc + tile`` into one FMA, eager
  torch rounds the product first, so results differ by at most an ulp of
  the quotient's inputs: ``rtol=2e-7``, ``atol=1e-30``.
* A step body built once and run with new block contents (frame, camera,
  tile, sky, jitter, ``lambertian``) equals a fresh ``Renderer.step``
  with those values, bit for bit: no Python value is baked into the body.
* The block written ahead: through sequences of steps (nothing changed, a
  camera moved or changed in place, resets, sky, jitter or ``lambertian``
  changed, a new ``accum``, a step taken again from the state before the
  last one, a sweep over four tiles) the body reads
  exactly its step's words, ``step.block_ahead_hits`` and ``_misses``
  count the steps that found the block written, and ``accum`` equals that
  of a renderer that writes its block at every step, bit for bit.
* Brute force's early exit is made on the device: a batch with no active
  ray reports misses, as before.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import opengl_raytracer_tpu.renderer as jrenderer
from opengl_raytracer_tpu.utils.config import RenderConfig as JRenderConfig

from opengl_raytracer_torch import (Rect, RenderConfig, Renderer, Scene,
                                    Triangles, make_camera)
from opengl_raytracer_torch.ops import fold, step_block
from opengl_raytracer_torch.ops import pallas_traversal as wide
from opengl_raytracer_torch.ops.intersect import BIG, Nearest, raycast_brute
from opengl_raytracer_torch.renderer import (RenderState, _tile_step,
                                             band_window, step_words)
from opengl_raytracer_torch.utils import profiling
from test_torch_render import _objects
from test_torch_traversal import _jax_scene, _rays
from test_torch_scene import jax_native  # noqa: F401 (autouse)

CAM = ([0.0, 0.0, 4.0], [180.0, 0.0])


# ---------------------------------------------------------------- block

@pytest.mark.parametrize("frame", [0, 2**24 + 1, 2**32 - 1, 2**40 + 7])
def test_block_words_round_trip(frame):
    cam = make_camera([1.5, -2.0, 30.25], [33.0, -12.5])
    words = step_block.pack(frame, (10, 20, 3, 4, 5), cam, 0.75, 0.125, False,
                            accum=0x7F12_3456_7890)
    block = step_block.new("cpu")
    step_block.write(block, words)
    v = step_block.values(block)
    assert (v.frame, v.accum, v.col0, v.py0, v.dx0, v.dy0, v.row0) == (
        frame, 0x7F12_3456_7890, 10, 20, 3, 4, 5)
    assert not v.lambertian and v.em_scale == 1.0 and v.jitter == 0.125
    for a, b in zip(v.camera, cam):
        np.testing.assert_array_equal(a, b)
    sky = np.asarray([0.1, 0.6, 0.92], np.float32) * np.float32(0.75)
    assert v.sky == tuple(float(x) for x in sky)
    assert int(step_block.frame_tensor(block)) == frame
    assert step_block.values(block)._replace(lambertian=True) != v


# ---------------------------------------------------------- G5 epilogue

def _raycast_pallas_inline(scene, o3, d3, active):
    """raycast_pallas before its prologue and epilogue were split out."""
    R = o3[0].shape[0]
    t0 = torch.full((R,), BIG, dtype=torch.float32)
    if active is not None:
        t0 = torch.where(active, t0, -BIG)
    t, slot, u, v = wide.traverse_wide(scene, o3, d3, t0)
    did_hit = (t < BIG) & (t > -BIG)
    return Nearest(t=torch.where(did_hit, t, BIG),
                   tri=scene.pl_remap[slot.long()],
                   u=torch.where(did_hit, u, 0.0),
                   v=torch.where(did_hit, v, 0.0))


@pytest.mark.parametrize("masked", [True, False])
def test_wide_epilogue_equals_the_inline_code(masked):
    jdata, tdata = _jax_scene(600)
    R = 900
    o, d = _rays(R, seed=8)
    o3 = tuple(torch.from_numpy(x.copy()) for x in o)
    d3 = tuple(torch.from_numpy(x.copy()) for x in d)
    active = (torch.from_numpy(np.random.default_rng(9).uniform(size=R)
                               < 0.7) if masked else None)
    got = wide.raycast_pallas(tdata, o3, d3, active)
    want = _raycast_pallas_inline(tdata, o3, d3, active)
    assert got.slot is None
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int((got.t < BIG).sum()) > R // 4
    if masked:
        assert (got.t[~active] == BIG).all()


def test_wide_prologue_and_epilogue_plain():
    """The entry t of a live and of a dead ray, and a miss's selects."""
    active = torch.tensor([True, False, True])
    assert torch.equal(wide.wide_prologue(active, 3, "cpu"),
                       torch.tensor([BIG, -BIG, BIG]))
    assert torch.equal(wide.wide_prologue(None, 2, "cpu"),
                       torch.full((2,), BIG))
    t = torch.tensor([2.5, BIG, -BIG, float("nan")])
    slot = torch.tensor([1, 0, 7, 2], dtype=torch.int32)  # 7: clamped
    uv = torch.tensor([0.25, 0.5, 0.75, 0.125])
    remap = torch.tensor([5, 6, 7], dtype=torch.int32)
    got = wide.wide_epilogue(t, slot, uv, uv, remap)
    assert torch.equal(got.t, torch.tensor([2.5, BIG, BIG, BIG]))
    assert got.tri.tolist() == [6, 5, 7, 7]
    assert got.u.tolist() == [0.25, 0.0, 0.0, 0.0]


# -------------------------------------------------------------- G6 fold

def _jax_fold(accum, colors, cfg, frame_count, tile_x, tile_y, monkeypatch):
    """The JAX tile step's merge of ``colors`` ((F * n_band, 3), the order
    its render_flat returns) into ``accum``."""
    monkeypatch.setattr(jrenderer, "render_flat",
                        lambda *a, **k: jnp.asarray(colors))
    jcfg = JRenderConfig(width=cfg.width, height=cfg.height,
                         tile_size=cfg.tile_size,
                         frames_per_step=cfg.frames_per_step)
    out = jrenderer._tile_step(
        None, None, jnp.asarray(accum), jnp.uint32(frame_count),
        jnp.int32(tile_x), jnp.int32(tile_y), jnp.float32(1.0),
        jnp.float32(0.0), jnp.asarray(True), config=jcfg, traversal="brute")
    return np.asarray(out)


@pytest.mark.parametrize("frame_count", [0, 5, 2**24 - 1, 2**24 + 3,
                                         2**32 - 2])
@pytest.mark.parametrize("F,tile_size", [(1, 3), (2, 3), (2, 1)])
def test_fold_plain_matches_jax_merge(frame_count, F, tile_size, monkeypatch):
    """Every tile of a sweep (tile_size 3 on 24x20 has remainder tiles
    along y: tile_h 6, 20 = 3 * 6 + 2) folded into one accumulation."""
    cfg = RenderConfig(width=24, height=20, tile_size=tile_size,
                       frames_per_step=F)
    g = np.random.default_rng(frame_count % 1000 + 10 * F + tile_size)
    accum = g.uniform(0, 2, (20, 24, 3)).astype(np.float32)
    ref, got = accum.copy(), torch.from_numpy(accum.copy())
    tw, th = cfg.tile_w, cfg.tile_h
    cam = make_camera(*CAM)
    block = step_block.new("cpu")
    for ty in range(cfg.num_tiles_y):
        for tx in range(cfg.num_tiles_x):
            colors = g.uniform(0, 3, (F * tw * th, 3)).astype(np.float32)
            ref = _jax_fold(ref, colors, cfg, frame_count, tx, ty,
                            monkeypatch)
            step_block.write(block, step_words(cfg, frame_count, tx, ty, cam,
                                               1.0, 0.0, True, got))
            cols = tuple(torch.from_numpy(colors[:, a].copy())
                         for a in range(3))
            fold.fold_band(got, cols, block, tw, th, F, F)
    assert not np.array_equal(ref, accum)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-7, atol=1e-30)


def test_fold_keeps_the_masked_pixels():
    """A remainder tile's leading rows and columns keep their bits."""
    cfg = RenderConfig(width=24, height=20, tile_size=3)
    accum = torch.full((20, 24, 3), -0.0)
    block = step_block.new("cpu")
    step_block.write(block, step_words(cfg, 1, 0, 3, make_camera(*CAM), 1.0,
                                       0.0, True, accum))
    col0, py0, dx0, dy0 = band_window(cfg, 0, 3)
    assert (py0, dy0) == (14, 4)
    n = cfg.tile_w * cfg.tile_h
    fold.fold_band(accum, tuple(torch.ones(n) for _ in range(3)), block,
                   cfg.tile_w, cfg.tile_h, 1, 1)
    changed = accum[..., 0] != 0
    assert changed[:2, :8].all() and not changed[2:].any()
    assert not changed[:, 8:].any()
    assert torch.signbit(accum[2:]).all()


# ------------------------------------------------- the body and its block

@pytest.fixture(scope="module")
def scene():
    return Scene(_objects(Rect, Triangles))


@pytest.mark.parametrize("cfg", [
    dict(tile_size=3, traversal="pallas2"),
    dict(tile_size=2, traversal="pallas", frames_per_step=2),
    dict(tile_size=1, traversal="brute", rays_per_pixel=2),
])
def test_body_built_once_reads_its_block(scene, cfg):
    """One renderer's body, built once, run after writing new values into
    its block, against a fresh Renderer.step with those values."""
    config = RenderConfig(width=24, height=20, bounces=2, **cfg)
    r = Renderer(scene, config, device="cpu")
    body = r._body
    g = np.random.default_rng(3)
    start = torch.from_numpy(g.uniform(0, 1, (20, 24, 3)).astype(np.float32))
    cases = [
        (0, 0, 0, CAM, 1.0, 0.001, True),
        (7, config.num_tiles_x - 1, config.num_tiles_y - 1,
         ([0.5, -0.25, 3.5], [170.0, 8.0]), 0.6, 0.01, False),
        (2**32 - 1, 0, config.num_tiles_y - 1,
         ([-0.3, 0.2, 4.2], [190.0, -5.0]), 1.7, 0.2, True),
    ]
    for frame, tx, ty, cam, sky, jitter, lam in cases:
        camera = make_camera(*cam)
        accum = start.clone()
        step_block.write(r._block, step_words(config, frame, tx, ty, camera,
                                              sky, jitter, lam, accum))
        body(accum)
        fresh = Renderer(scene, config, device="cpu")
        state = RenderState(accum=start.clone(), frame_count=frame,
                            tile_x=tx, tile_y=ty)
        fresh.step(state, camera, sky, jitter, lam)
        assert torch.equal(accum, state.accum)
        assert not torch.equal(accum, start)


# What changes before each step of a sequence ("" nothing): "move" a new
# camera, "nudge" the same camera's position changed in place, "reset",
# "sky", "jitter", "lambertian", "accum" a new buffer at the same counters,
# "again" the state before the last step once more (its frame count, and
# where a sweep has several tiles its tile cursor, not the predicted ones)
_AHEAD = {
    "still": ("",) * 5,
    "camera": ("", "", "move", "", "nudge", ""),
    "reset": ("", "", "reset", "", "reset"),
    "settings": ("", "sky", "", "jitter", "", "lambertian", ""),
    "accum": ("", "", "accum", ""),
    "again": ("", "", "again", "", "again"),
    "tiles": ("", "", "again") + ("",) * 5,  # 4 tiles a sweep
}


@pytest.mark.parametrize("case", sorted(_AHEAD))
def test_block_written_ahead(scene, case):
    """A step finds its block written by the step before it where its
    inputs are the predicted ones, and writes its own otherwise: the body
    reads exactly the step's words, the counters say which steps found it,
    and ``accum`` equals, bit for bit, that of a renderer whose every step
    writes its own block (its prediction dropped before each step)."""
    config = RenderConfig(width=16, height=12, bounces=2,
                          tile_size=2 if case == "tiles" else 1)
    r = Renderer(scene, config, device="cpu")
    ref = Renderer(scene, config, device="cpu")
    read, body = [], r._body

    def spy(accum):
        read.append(r._block.clone().numpy())
        body(accum)

    r._body = spy
    camera = make_camera(*CAM)
    sky, jitter, lam = 1.0, config.jitter_amount, True
    sa, sb = r.init_state(), ref.init_state()
    got, want = [], []
    for k, change in enumerate(_AHEAD[case]):
        if change == "move":
            camera = make_camera([0.5, -0.25, 3.5], [170.0, 8.0])
        elif change == "nudge":
            camera.pos[0] += 0.25
        elif change == "reset":
            sa, sb = r.reset(sa), ref.reset(sb)
        elif change == "sky":
            sky = 0.6
        elif change == "jitter":
            jitter = 0.05
        elif change == "lambertian":
            lam = not lam
        elif change == "accum":
            sa = dataclasses.replace(sa, accum=sa.accum.clone())
        elif change == "again":
            sa, sb = last
        last = sa, sb
        want.append("step.block_ahead_misses" if k == 0 or change
                    else "step.block_ahead_hits")
        words = step_words(config, sa.frame_count, sa.tile_x, sa.tile_y,
                           camera, sky, jitter, lam, sa.accum)
        before = profiling.counts()
        sa = r.step(sa, camera, sky, jitter, lam)
        got.append({name for name, n in profiling.counts().items()
                    if name.startswith("step.block_ahead_")
                    and n != before.get(name, 0)})
        ref._ahead = (None, None)
        sb = ref.step(sb, camera, sky, jitter, lam)
        assert np.array_equal(read[-1], words), (case, k)
        assert torch.equal(sa.accum.view(torch.int32),
                           sb.accum.view(torch.int32)), (case, k)
    if case == "tiles":  # past a sweep's end
        assert (sa.frame_count, sa.tile_x, sa.tile_y) == (1, 1, 1)
    assert got == [{w} for w in want]
    assert float(sa.accum.mean()) > 0.01


def test_tile_step_folds_the_accum_it_is_given(scene):
    """On the CPU the fold takes the tensor; a step refuses an ``accum``
    of the wrong shape, type or layout before it renders."""
    cfg = RenderConfig(width=16, height=16, bounces=1, traversal="pallas2")
    r = Renderer(scene, cfg, device="cpu")
    block = step_block.new("cpu")
    accum = torch.zeros((16, 16, 3))
    step_block.write(block, step_words(cfg, 0, 0, 0, make_camera(*CAM), 1.0,
                                       0.0, True, accum))
    _tile_step(r.scene, block, accum, config=cfg, raycast_fn=r._raycast,
               traversal=r.traversal)
    assert accum.abs().sum() > 0
    bad = [torch.zeros((16, 16, 3), dtype=torch.float64),
           torch.zeros((16, 8, 3)),
           torch.zeros((16, 3, 16)).transpose(1, 2)]
    for acc in bad:
        with pytest.raises(ValueError, match="accum must be"):
            r.step(RenderState(accum=acc), make_camera(*CAM))


# ------------------------------------------------------------- G7 walk

def test_bvh_walk_counts_its_work():
    """The plain walk's counts (the chip's bound for G7): one visit a loop
    step of a live ray, the triangles of each entered leaf, the candidates
    among them; a dead ray follows the miss links and tests nothing."""
    from opengl_raytracer_torch.ops import traversal

    _, tdata = _jax_scene(300)
    o, d = _rays(400, seed=4)
    o3 = tuple(torch.from_numpy(x.copy()) for x in o)
    d3 = tuple(torch.from_numpy(x.copy()) for x in d)
    active = torch.arange(400) % 5 != 0
    leaf = tdata.max_leaf
    near, work = traversal._walk_plain(tdata, o3, d3, active, leaf,
                                       counts=True)
    plain = traversal.raycast_bvh(tdata, o3, d3, active, leaf)
    for a, b in zip(near[:4], plain[:4]):
        assert torch.equal(a, b)
    assert (work[0] > 0).all() and (work[1][~active] == 0).all()
    assert int(work[1][active].sum()) > 400
    # a candidate (a test whose t would win) is a test; every hit's winner
    # was one
    assert (work[2] <= work[1]).all() and (work[2][near.t < BIG] >= 1).all()


# ---------------------------------------------------------------- brute

def test_brute_without_active_rays_reports_misses():
    """A dead ray skips the sweep and reports init_nearest's miss, as the
    sweep kernel does: no active ray gives misses everywhere, and one
    active ray the sweep's hit for that ray and misses for the rest."""
    _, tdata = _jax_scene(300)
    o, d = _rays(256, seed=3)
    o3 = tuple(torch.from_numpy(x.copy()) for x in o)
    d3 = tuple(torch.from_numpy(x.copy()) for x in d)
    none = raycast_brute(tdata, o3, d3, torch.zeros(256, dtype=torch.bool))
    assert (none.t == BIG).all() and not none.tri.any()
    assert not none.u.any() and not none.v.any()
    everyone = raycast_brute(tdata, o3, d3)
    one = torch.zeros(256, dtype=torch.bool)
    one[5] = True
    some = raycast_brute(tdata, o3, d3, one)
    assert everyone.t[5] < BIG
    for a, b in zip(some[:4], everyone[:4]):
        assert torch.equal(a[5], b[5])
    assert torch.equal(some.t[~one], none.t[~one])
    for a in some[1:4]:
        assert not a[~one].any()
