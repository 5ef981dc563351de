"""The plain versions of the main path's glue kernels (G1-G3) and of K1's
part-chain resolution against the JAX package, on the CPU, and against
the torch code they were split out of.

* G1, the ray front (``ops/front.py``): its math for given pixels
  (``pixel_front``) against the JAX ``render_pixels``' hand-off to
  ``trace``, with frame numbers near 2^32 (an int and per-ray tensors that
  wrap), the frame's corner pixels and pixel coordinates whose products
  with 1973 and 9277 wrap.  Seeds and origins exact; directions within
  1e-6 (two float32 programs of the same formulas), as
  tests/test_torch_rng_camera.py holds them.  Each step ray's pixel and
  frame number, derived from its index and the step block, are the pixel
  lists the renderer built before.
* G2, the int32 sort keys (``ops/morton.py``): the JAX uint32 keys minus
  2^31, bit for bit, on live, dead and out-of-box rays; a stable argsort
  of them is the stable argsort of the uint32 keys.
* G3, the reorder and restore (``ops/permute.py``), on G10's sort of the
  keys (``ops/radix_sort.py``, its int32 permutation): restore after
  reorder is the identity; both equal the integrator's former inline code
  bit for bit wherever the frame reads a column again; the plain reorder
  equals the JAX sort's fold
  (``opengl_raytracer_tpu/ops/integrator.py:251-268``) on the same state; and on a small frame every live ray's incoming light
  is +0.0 in bits after each bounce, the fact the fold rests on.
* K1's part chain and its resolution of the hits
  (``ops/subblock_traversal.py:_chain_plain``, the plain version of the
  chain kernel, which also does what G4's launches did before it): on a
  4-part scene with an active mask, the port's ``raycast_subblock`` against the
  JAX ``raycast_subblock`` in interpret mode (the tolerances of
  tests/test_torch_traversal.py: exact-t ties may pick another triangle),
  and against the former inline part loop bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import opengl_raytracer_tpu.renderer as jrenderer
from opengl_raytracer_tpu.ops.camera import make_camera as j_make_camera
from opengl_raytracer_tpu.ops.morton import ray_sort_keys_soa as j_keys
from opengl_raytracer_tpu.ops.subblock_traversal import (
    raycast_subblock as j_subblock)
from opengl_raytracer_tpu.utils.config import RenderConfig as JRenderConfig

from opengl_raytracer_torch.ops import front, morton, permute, radix_sort
from opengl_raytracer_torch.ops import step_block
from opengl_raytracer_torch.ops import subblock_traversal as sbt
from opengl_raytracer_torch.ops.camera import make_camera
from opengl_raytracer_torch.ops.front import (pixel_front, ray_front,
                                              ray_front_plain)
from opengl_raytracer_torch.ops.intersect import BIG, Nearest
from opengl_raytracer_torch.utils.config import RenderConfig
from test_torch_traversal import _check, _jax_scene, _rays, _run_port
from test_torch_scene import jax_native  # noqa: F401 (autouse)
from torch_states import recon_states

CAM_POS, CAM_DIR = (-33.7, 14.8, -21.1), (65.0, -25.4)
W, H = 1920, 1080


# ------------------------------------------------------------- G1 front

def _front_pixels(case, g):
    """(px, py) int64 and the port's and the JAX package's frame number."""
    n = 4096
    px = g.integers(0, W, n)
    py = g.integers(0, H, n)
    px[:4], py[:4] = [0, W - 1, 0, W - 1], [0, 0, H - 1, H - 1]  # corners
    if case == "frame_int":
        return px, py, 2**32 - 1, np.uint32(2**32 - 1)
    if case == "frame_tensor_wrap":  # frames_per_step = 4 from 2^32 - 2
        frames = 2**32 - 2 + np.repeat(np.arange(4), n // 4)
    else:  # "wide_pixels": px * 1973 and py * 9277 wrap mod 2^32
        px = g.integers(0, 2**31 - 1, n)
        py = g.integers(0, 2**31 - 1, n)
        frames = g.integers(0, 2**40, n)
    return px, py, torch.from_numpy(frames), frames.astype(np.uint32)


@pytest.mark.parametrize("case", ["frame_int", "frame_tensor_wrap",
                                  "wide_pixels"])
def test_front_plain_matches_jax_render_pixels(case, monkeypatch):
    """The front's math for given pixels (``pixel_front``) against what the
    JAX render_pixels hands to trace (renderer.py:162-199)."""
    seen = {}

    def fake_trace(scene, raycast_fn, origin, d, seed, sky, **kw):
        seen["jax"] = (jnp.stack(origin), jnp.stack(d), seed)
        return jnp.zeros((d[0].shape[0], 3)), seed

    monkeypatch.setattr(jrenderer, "trace", fake_trace)
    px, py, frame, j_frame = _front_pixels(case, np.random.default_rng(7))
    j_frame = j_frame if np.ndim(j_frame) == 0 else jnp.asarray(j_frame)
    jrenderer.render_pixels(None, JRenderConfig(width=W, height=H),
                            j_make_camera(CAM_POS, CAM_DIR), j_frame, 0.8,
                            0.05, True, jnp.asarray(px.astype(np.int32)),
                            jnp.asarray(py.astype(np.int32)), None)
    o3, d3, ts = pixel_front(torch.from_numpy(px), torch.from_numpy(py),
                             frame, make_camera(CAM_POS, CAM_DIR), W, H, None,
                             0.05)
    jo, jd, js = seen["jax"]
    to, td = torch.stack(o3), torch.stack(d3)
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())
    assert ts.dtype == torch.int64 and (ts >= 0).all() and (ts < 2**32).all()


def _front_block(frame, col0, py0, jitter=0.05):
    block = step_block.new("cpu")
    step_block.write(block, step_block.pack(
        frame, (col0, py0, 0, 0, 0), make_camera(CAM_POS, CAM_DIR), 0.8,
        jitter, True))
    return block


def test_front_runs_plain_on_cpu_tensors():
    """On a CPU block the wrapper is the plain version, bit for bit: the
    pixels and frame numbers it derives, then ``pixel_front``."""
    tw, rows, F = 40, 7, 4  # frames_per_step = 4 from 2^32 - 2
    block = _front_block(2**32 - 2, 100, 60, jitter=0.3)
    n_band = tw * rows
    args = (block, 128, 640, F * n_band, n_band, tw, W, H, 1.25)
    got, ref = ray_front(*args), ray_front_plain(*args)
    px, py, frames = front.band_pixels(100, 60, 2**32 - 2, 128, 640,
                                       F * n_band, n_band, tw, "cpu")
    want = pixel_front(px, py, frames, make_camera(CAM_POS, CAM_DIR), W, H,
                       1.25, 0.3)
    for a, b, c in zip(got, ref, want):
        for x, y, z in zip(a if isinstance(a, tuple) else (a,),
                           b if isinstance(b, tuple) else (b,),
                           c if isinstance(c, tuple) else (c,)):
            assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.parametrize("F,n,tw,rows", [(1, 1024, 64, 16), (3, 640, 24, 9),
                                         (2, 300, 30, 5)])
def test_band_pixels_are_the_former_pixel_lists(F, n, tw, rows):
    """Each step ray's pixel and frame number, derived from its index, as
    the renderer listed them before the step block (``band_pixels`` of
    the band, repeated F times, frames ``frame + arange(F)`` repeated per
    band pixel, chunks of ``n`` rays padded with pixel (0, 0))."""
    col0, py0, frame = 17, 33, 2**32 - 1
    cols = torch.arange(tw, dtype=torch.int64)
    ys = torch.arange(rows, dtype=torch.int64)
    px = (col0 + cols)[None, :].expand(rows, tw).reshape(-1).repeat(F)
    py = (py0 + ys)[:, None].expand(rows, tw).reshape(-1).repeat(F)
    frames = frame + torch.arange(F).repeat_interleave(tw * rows)
    R = F * tw * rows
    for base in range(0, R, n):
        got = front.band_pixels(col0, py0, frame, base, n, R, tw * rows, tw,
                                "cpu")
        real = min(n, R - base)
        for g, w in zip(got, (px, py, frames)):
            assert torch.equal(g[:real], w[base:base + real])
        assert (got[0][real:] == 0).all() and (got[1][real:] == 0).all()
        assert (got[2][real:] == frame).all()


# -------------------------------------------------------------- G2 keys

LO = np.asarray([-4.0, -2.5, -3.0], np.float32)
HI = np.asarray([5.0, 3.5, 2.0], np.float32)


def _key_rays(R, seed):
    """Live rays in the box, out-of-box origins (clamped), a few far out,
    axis-parallel directions, and dead rays."""
    g = np.random.default_rng(seed)
    o = g.uniform(-6, 6, (3, R)).astype(np.float32)
    o[:, :16] = g.uniform(-1e6, 1e6, (3, 16)).astype(np.float32)
    d = g.normal(size=(3, R)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    d[:, 16:24] = np.asarray([[1, 0, 0]] * 8, np.float32).T
    d[:, 24:32] = np.asarray([[0, 0, -1]] * 8, np.float32).T
    alive = g.uniform(size=R) < 0.7
    return o, d, alive


@pytest.mark.parametrize("R", [1000, 4096])
def test_int32_keys_are_jax_keys_minus_2_31(R):
    o, d, alive = _key_rays(R, R)
    ref = np.asarray(j_keys(tuple(jnp.asarray(x) for x in o),
                            tuple(jnp.asarray(x) for x in d),
                            jnp.asarray(LO), jnp.asarray(HI),
                            jnp.asarray(alive)))
    args = (tuple(torch.from_numpy(x) for x in o),
            tuple(torch.from_numpy(x) for x in d), LO, HI,
            torch.from_numpy(alive))
    got = morton.sort_keys_i32_plain(*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        (ref.astype(np.int64) - 2**31).astype(np.int32), got.numpy())
    assert (got[~torch.from_numpy(alive)] == morton.DEAD_KEY32).all()
    assert (got[torch.from_numpy(alive)] < morton.DEAD_KEY32).all()
    assert torch.equal(morton.sort_keys(*args), got)  # CPU: the plain one
    # the sort the integrator runs gives the uint32 keys' permutation
    u32 = morton.ray_sort_keys_soa(*args)
    assert torch.equal(torch.argsort(got, stable=True),
                       torch.argsort(u32, stable=True))


# ------------------------------------------------------- G3 permutation

def _state(R, seed):
    """12 float columns, int32 keys with ~30% dead, seeds; a live ray's
    incoming light is +0.0, as the integrator keeps it."""
    g = np.random.default_rng(seed)
    cols = [torch.from_numpy(g.normal(size=R).astype(np.float32))
            for _ in range(12)]
    keys = torch.from_numpy(g.integers(-2**31, 2**31 - 1, R).astype(np.int32))
    keys[torch.from_numpy(g.uniform(size=R) < 0.3)] = morton.DEAD_KEY32
    seed_col = torch.from_numpy(g.integers(0, 2**32, R).astype(np.int64))
    live = keys != morton.DEAD_KEY32
    for c in cols[9:]:
        c[live] = 0.0
    return cols, keys, seed_col


def _groups(cols):
    return tuple(tuple(cols[3 * k:3 * k + 3]) for k in range(4))


def _bits(x):
    return x.view(torch.int32)


def test_restore_after_reorder_is_identity():
    R = 5000
    cols, keys, seed = _state(R, 1)
    keys_s, perm = radix_sort.sort_rays(keys)
    orig = torch.arange(R, dtype=torch.int32)
    n_dead = int((keys == morton.DEAD_KEY32).sum())
    for return_seed in (True, False):
        o, d, rc, inc, alive, seed_s, orig_s = permute.reorder(
            keys_s, perm, *_groups(cols), seed, orig, return_seed)
        assert orig_s.dtype == torch.int32
        assert torch.equal(orig_s, perm)
        assert torch.equal(alive, keys[perm] != morton.DEAD_KEY32)
        assert alive[:-n_dead].all() and not alive[-n_dead:].any()
        back, seed_b = permute.restore(inc, seed_s if return_seed else None,
                                       orig_s)
        for a in range(3):
            assert torch.equal(_bits(back[a]), _bits(cols[9 + a]))
        if return_seed:
            assert torch.equal(seed_b, seed)
        else:
            assert seed_b is None
            assert torch.equal(seed_s[alive], seed[perm][alive])
            assert (seed_s[~alive] == 0).all()


def _reorder_inline(keys_u32, perm, origin, direction, ray_color, incoming,
                    seed, orig):
    """The integrator's reorder before it was split out (uint32 keys)."""
    cols = torch.stack([*origin, *direction, *ray_color, *incoming])
    cols = cols[:, perm]
    origin, direction, ray_color, incoming = (
        tuple(cols[3 * g + a] for a in range(3)) for g in range(4))
    alive = keys_u32[perm] != morton.DEAD_KEY
    return origin, direction, ray_color, incoming, alive, seed[perm], \
        orig[perm]


def _restore_inline(incoming, seed, orig):
    light = torch.stack(incoming)
    out = torch.empty_like(light)
    out[:, orig] = light
    seed_out = torch.empty_like(seed)
    seed_out[orig] = seed
    return tuple(out[a] for a in range(3)), seed_out


def _flat(x):
    return [y for z in x for y in (z if isinstance(z, tuple) else (z,))]


def test_split_reorder_and_restore_equal_the_inline_code():
    """Bit for bit wherever the frame reads a column again: a live ray's
    every column, every ray's incoming light, alive, the index, and the
    seed (with ``return_seed``; a live ray's without); the columns the
    fold drops are zeros."""
    R = 4099
    cols, keys, seed = _state(R, 2)
    keys_u32 = keys.long() + 2**31
    g = torch.Generator().manual_seed(3)
    perm = torch.randperm(R, generator=g)
    orig = torch.randperm(R, generator=g).int()
    groups = _groups(cols)
    want = _reorder_inline(keys_u32, perm, *groups, seed, orig)
    live = want[4]
    for return_seed in (True, False):
        got = permute.reorder_plain(keys[perm], perm, *groups, seed, orig,
                                    return_seed)
        for k in range(3):  # origin, direction, ray colour
            for a, b in zip(got[k], want[k]):
                assert a.dtype == b.dtype
                assert torch.equal(_bits(a[live]), _bits(b[live]))
                assert (_bits(a[~live]) == 0).all()
        for a, b in zip(got[3], want[3]):  # incoming light, every ray
            assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(got[4], live)
        assert torch.equal(got[6], want[6]) and got[6].dtype == torch.int32
        if return_seed:
            assert torch.equal(got[5], want[5])
        else:
            assert torch.equal(got[5][live], want[5][live])
            assert (got[5][~live] == 0).all()
    for a, b in zip(_flat(permute.restore_plain(groups[3], seed, orig)),
                    _flat(_restore_inline(groups[3], seed, orig))):
        assert torch.equal(a, b)
    light, no_seed = permute.restore_plain(groups[3], None, orig)
    assert no_seed is None
    for a, b in zip(light, _restore_inline(groups[3], seed, orig)[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("return_seed", [True, False])
def test_plain_reorder_equals_the_jax_sort_fold(return_seed):
    """The same state through the JAX reorder's sort and fold
    (``integrator.py:235, :251-268``) and through ``reorder_plain``: a
    live ray's origin, direction, ray colour, seed and index, and every
    ray's incoming light and alive, equal.  ``is_stable=True``: only dead
    rays share a key, and the JAX sort may leave them in any order."""
    import jax

    R = 3001
    cols, keys, seed = _state(R, 4)
    orig = np.random.default_rng(5).permutation(R).astype(np.int32)
    alive_in = jnp.asarray((keys != morton.DEAD_KEY32).numpy())
    c = [jnp.asarray(x.numpy()) for x in cols]
    merged = tuple(jnp.where(alive_in, c[a], c[9 + a]) for a in range(3))
    keys_u32 = (keys.numpy().astype(np.int64) + 2**31).astype(np.uint32)
    (keys_j, m0, m1, m2, d0, d1, d2, c0, c1, c2, seed_j, orig_j) = \
        jax.lax.sort((jnp.asarray(keys_u32), *merged, *c[3:9],
                      jnp.asarray(seed.numpy().astype(np.uint32)),
                      jnp.asarray(orig)), num_keys=1, is_stable=True)
    alive_j = np.asarray(keys_j != np.uint32(0xFFFFFFFF))
    inc_j = [np.asarray(jnp.where(alive_j, jnp.zeros_like(m), m))
             for m in (m0, m1, m2)]

    keys_s, perm = radix_sort.sort_rays(keys)
    got = permute.reorder_plain(keys_s, perm, *_groups(cols), seed,
                                torch.from_numpy(orig), return_seed)
    live = got[4].numpy()
    np.testing.assert_array_equal(live, alive_j)
    for col, ref in zip((*got[0], *got[1], *got[2]),
                        (m0, m1, m2, d0, d1, d2, c0, c1, c2)):
        np.testing.assert_array_equal(col.numpy()[live].view(np.uint32),
                                      np.asarray(ref)[live].view(np.uint32))
    for col, ref in zip(got[3], inc_j):
        np.testing.assert_array_equal(col.numpy().view(np.uint32),
                                      ref.view(np.uint32))
    np.testing.assert_array_equal(got[5].numpy()[live],
                                  np.asarray(seed_j)[live].astype(np.int64))
    np.testing.assert_array_equal(got[6].numpy()[live],
                                  np.asarray(orig_j)[live])


def test_live_rays_carry_no_light_after_each_bounce(monkeypatch):
    """On a small "pallas2" frame on the CPU: after each bounce segment
    every live ray's incoming light is +0.0 in bits, and so it is on the
    reorder's input: the fold writes +0.0 for it without a read."""
    from opengl_raytracer_torch import Rect, Renderer, Scene, Triangles
    from opengl_raytracer_torch.ops import shade
    from test_torch_render import CAM, _objects

    seen = {"shade": 0, "reorder": 0}
    shade_update, reorder = shade.shade_update, permute.reorder

    def check_shade(*args):
        out = shade_update(*args)
        alive = out[4]
        for a in range(3):
            assert (_bits(out[3][a])[alive] == 0).all()
        seen["shade"] += 1
        return out

    def check_reorder(keys_s, perm, origin, direction, ray_color, incoming,
                      seed, orig, *rest):
        live = torch.empty_like(keys_s, dtype=torch.bool)
        live[perm] = keys_s != morton.DEAD_KEY32
        assert 0 < int(live.sum()) < live.numel()
        for a in range(3):
            assert (_bits(incoming[a])[live] == 0).all()
        seen["reorder"] += 1
        return reorder(keys_s, perm, origin, direction, ray_color, incoming,
                       seed, orig, *rest)

    monkeypatch.setattr(shade, "shade_update", check_shade)
    monkeypatch.setattr(permute, "reorder", check_reorder)
    r = Renderer(Scene(_objects(Rect, Triangles)),
                 RenderConfig(width=16, height=16, bounces=3,
                              traversal="pallas2"), device="cpu")
    img = r.image(r.render(make_camera(*CAM), frames=1))
    assert np.isfinite(img).all() and img.mean() > 0.05
    assert seen == {"shade": 4, "reorder": 3}


# -------------------------------------------- K1's part-chain resolution

def test_epilogue_on_four_parts_matches_jax(monkeypatch):
    """The JAX kernel in interpret mode, with an active mask, on a scene
    split into 4 parts: every part after the first combines with the
    earlier parts' hits and prunes against their t."""
    jdata, tdata = _jax_scene(800, 64 * 1024, monkeypatch)
    assert len(tdata.k1_parts) == 4
    R = 512
    o, d = _rays(R, seed=4)
    active = np.random.default_rng(9).uniform(size=R) < 0.7
    ref = j_subblock(jdata, tuple(jnp.asarray(x) for x in o),
                     tuple(jnp.asarray(x) for x in d), jnp.asarray(active),
                     interpret=True)
    got = _run_port(tdata, o, d, active)
    _check(jdata, ref, got, o, d, active)
    assert (got.t.numpy()[active] < BIG).sum() > R // 4


def _raycast_inline(scene, o3, d3, active):
    """raycast_subblock's part loop before the epilogue was split out."""
    R = o3[0].shape[0]
    near = None
    slot_base = 0
    for nodes, octets, remap in scene.k1_parts:
        t0 = (torch.full((R,), BIG, dtype=torch.float32)
              if near is None else near.t)
        if active is not None:
            t0 = torch.where(active, t0, -BIG)
        t, slot, u, v, _ = sbt._traverse_plain(nodes, octets, o3, d3,
                                               t0.contiguous())
        did_hit = (t < BIG) & (t > -BIG)
        slot = slot.clamp(0, remap.shape[0] - 1)
        pn = Nearest(t=torch.where(did_hit, t, BIG), tri=remap[slot.long()],
                     u=torch.where(did_hit, u, 0.0),
                     v=torch.where(did_hit, v, 0.0), slot=slot + slot_base)
        slot_base += int(remap.shape[0])
        if near is None:
            near = pn
        else:
            better = pn.t < near.t
            near = Nearest(*(torch.where(better, a, b)
                             for a, b in zip(pn, near)))
    if active is not None:
        near = near._replace(t=torch.where(active, near.t, BIG))
    return near


@pytest.mark.parametrize("masked", [True, False])
def test_split_epilogue_equals_the_inline_loop(masked, monkeypatch):
    _, tdata = _jax_scene(800, 64 * 1024, monkeypatch)
    R = 700
    o, d = _rays(R, seed=5)
    o3 = tuple(torch.from_numpy(x) for x in o)
    d3 = tuple(torch.from_numpy(x) for x in d)
    active = (torch.from_numpy(np.random.default_rng(6).uniform(size=R)
                               < 0.6) if masked else None)
    got = sbt.raycast_subblock(tdata, o3, d3, active)
    want = _raycast_inline(tdata, o3, d3, active)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("frame", [2**32 - 2, 7])
def test_reorder_plain_recon_equals_carried_seed(frame):
    """Seed reconstruction in the reorder's plain version: on a step's own
    states from ``ray_front_plain`` at bounces 1-4 (frames_per_step 2,
    padding rays past the step's rays, frame numbers at 2^32 - 2 and 7),
    every live ray's rebuilt seed equals its carried one, so all outputs
    equal the carried-seed reorder's byte for byte."""
    n_padded_live = 0
    for name, st, recon, draws in recon_states("cpu", frame):
        ref = permute.reorder_plain(*st, False)
        got = permute.reorder_plain(*st, False, recon, draws)
        for a, b in zip(_flat(got), _flat(ref)):
            assert a.dtype == b.dtype
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
        alive, seed = got[4], got[5]
        assert (seed[~alive] == 0).all()
        n_padded_live += int((alive & (recon.base + got[6] >= recon.n_rays))
                             .sum())
    assert n_padded_live > 0  # padding rays were rebuilt too


def test_reorder_recon_needs_return_seed_off():
    name, st, recon, draws = recon_states("cpu", 3)[0]
    with pytest.raises(ValueError, match="return_seed"):
        permute.reorder(*st, True, recon, draws)
