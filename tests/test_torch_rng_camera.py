"""The torch port's RNG, camera rays and per-pixel ray front against the
JAX package, on the same NumPy inputs.

RNG states, values and seeds must be BIT-exact (the port holds uint32
states in int64); ray directions agree within 1e-6 (two float32 programs
of the same formulas)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import opengl_raytracer_tpu.renderer as jrenderer
from opengl_raytracer_tpu.ops import rng as jrng
from opengl_raytracer_tpu.ops.camera import make_camera as j_make_camera
from opengl_raytracer_tpu.ops.camera import pixel_uv as j_pixel_uv
from opengl_raytracer_tpu.ops.camera import ray_dirs as j_ray_dirs
from opengl_raytracer_tpu.ops.camera import ray_dirs_soa as j_ray_dirs_soa
from opengl_raytracer_tpu.utils.config import RenderConfig as JRenderConfig

import opengl_raytracer_torch.renderer as trenderer
from opengl_raytracer_torch.ops import rng, step_block
from opengl_raytracer_torch.ops.camera import (make_camera, pixel_uv, ray_dirs,
                                               ray_dirs_soa)
from opengl_raytracer_torch.utils.config import RenderConfig

CAM_POS, CAM_DIR = (-33.7, 14.8, -21.1), (65.0, -25.4)


def _states(n=4096, seed=0):
    g = np.random.default_rng(seed)
    s = g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    s[:4] = [0, 1, 2**31, 2**32 - 1]
    assert (s >= 2**31).sum() > n // 4
    return s


def test_random_value_bit_exact():
    s = _states()
    js, ts = jnp.asarray(s), torch.from_numpy(s.astype(np.int64))
    for _ in range(4):
        js, jv = jrng.random_value(js)
        ts, tv = rng.random_value(ts)
        np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                      ts.numpy())
        np.testing.assert_array_equal(np.asarray(jv).view(np.uint32),
                                      tv.numpy().view(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(jrng.warmup(jnp.asarray(s), 3)).astype(np.int64),
        rng.warmup(torch.from_numpy(s.astype(np.int64)), 3).numpy())


@pytest.mark.parametrize("n", [1, 5, 8, 17])
def test_advance_n_bit_exact(n):
    s = _states(seed=n)
    ref = np.asarray(jrng.advance_n(jnp.asarray(s), n)).astype(np.int64)
    got = rng.advance_n(torch.from_numpy(s.astype(np.int64)), n)
    np.testing.assert_array_equal(ref, got.numpy())
    # and equal to n sequential draws
    t = torch.from_numpy(s.astype(np.int64))
    for _ in range(n):
        t, _ = rng.random_value(t)
    np.testing.assert_array_equal(t.numpy(), got.numpy())


def test_seed_pixels_bit_exact():
    g = np.random.default_rng(3)
    px = g.integers(0, 4096, 2048).astype(np.int32)
    py = g.integers(0, 4096, 2048).astype(np.int32)
    frames = g.integers(0, 2**31 - 1, 2048).astype(np.int32)
    for frame in (0, 7, 2**31 - 1):
        ref = np.asarray(jrng.seed_pixels(jnp.asarray(px), jnp.asarray(py),
                                          frame))
        got = rng.seed_pixels(torch.from_numpy(px), torch.from_numpy(py), frame)
        np.testing.assert_array_equal(ref.astype(np.int64), got.numpy())
    ref = np.asarray(jrng.seed_pixels(jnp.asarray(px), jnp.asarray(py),
                                      jnp.asarray(frames)))
    got = rng.seed_pixels(torch.from_numpy(px), torch.from_numpy(py),
                          torch.from_numpy(frames))
    np.testing.assert_array_equal(ref.astype(np.int64), got.numpy())


def test_pixel_uv_and_ray_dirs():
    W, H = 1920, 1080
    g = np.random.default_rng(4)
    px = g.integers(0, W, 4096).astype(np.int32)
    py = g.integers(0, H, 4096).astype(np.int32)
    ju, jv = j_pixel_uv(jnp.asarray(px), jnp.asarray(py), W, H)
    tu, tv = pixel_uv(torch.from_numpy(px), torch.from_numpy(py), W, H)
    np.testing.assert_allclose(np.asarray(ju), tu.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), rtol=0, atol=1e-6)
    for aspect in (None, 1.25):
        jd = j_ray_dirs_soa(j_make_camera(CAM_POS, CAM_DIR), ju, jv, W, H,
                            aspect=aspect)
        td = ray_dirs_soa(make_camera(CAM_POS, CAM_DIR), tu, tv, W, H,
                          aspect=aspect)
        for a in range(3):
            np.testing.assert_allclose(np.asarray(jd[a]), td[a].numpy(),
                                       rtol=0, atol=1e-6)


def test_render_pixels_front(monkeypatch):
    """Seed, warm-ups, angle-linear ray and the two jitter draws
    (renderer.py:162-199): capture what each render_pixels hands to trace."""
    seen = {}

    def capture(key, zeros, stack, sky_of):
        def fake_trace(scene, raycast_fn, origin, d, seed, sky, **kw):
            seen[key] = (stack(origin), stack(d), seed, sky_of(sky))
            return zeros((d[0].shape[0], 3)), seed
        return fake_trace

    monkeypatch.setattr(jrenderer, "trace",
                        capture("jax", jnp.zeros, lambda c: jnp.stack(c),
                                lambda sky: sky))
    monkeypatch.setattr(trenderer, "trace",
                        capture("torch", torch.zeros, lambda c: torch.stack(c),
                                lambda block: step_block.values(block).sky))
    W, H = 64, 36
    px = np.tile(np.arange(W, dtype=np.int32), H)
    py = np.repeat(np.arange(H, dtype=np.int32), W)
    jrenderer.render_pixels(None, JRenderConfig(width=W, height=H),
                            j_make_camera(CAM_POS, CAM_DIR), 11, 0.8, 0.05,
                            True, jnp.asarray(px), jnp.asarray(py), None)
    # the port's front derives the same pixels, the whole frame as one band
    # from (0, 0), from the step block's window
    block = step_block.new("cpu")
    step_block.write(block, step_block.pack(
        11, (0, 0, 0, 0, 0), make_camera(CAM_POS, CAM_DIR), 0.8, 0.05, True))
    trenderer.render_pixels(None, RenderConfig(width=W, height=H), block, 0,
                            W * H, W * H, W * H, W, None)
    jo, jd, js, jsky = seen["jax"]
    to, td, ts, tsky = seen["torch"]
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jsky), np.float32(tsky))


@pytest.mark.parametrize("bounce", [0, 1, 2, 3, 4])
def test_advance_constants_are_the_frames_draws(bounce):
    """Seed reconstruction's (a_n, c_n) before bounce segment ``bounce`` of
    a 5-segment frame: three warm-ups, two jitter draws and 3 draws a
    segment lived through, one after another, give the same states."""
    s = _states(seed=30 + bounce)
    t = rng.warmup(torch.from_numpy(s.astype(np.int64)), 3)
    for _ in range(2 + 3 * bounce):
        t, _ = rng.random_value(t)
    a, c = rng.advance_constants(5 + 3 * bounce)
    assert (a, c) == tuple(int(x) for x in jrng.advance_constants(
        5 + 3 * bounce))
    assert 0 <= a < 2**32 and 0 <= c < 2**32
    np.testing.assert_array_equal(
        (s.astype(np.uint64) * np.uint64(a) + np.uint64(c))
        .astype(np.uint32).astype(np.int64), t.numpy())


def test_random_vec3_matches_jax():
    """States bit for bit, values to float32 rounding (here exact)."""
    s = _states(seed=3).reshape(64, 64)
    js, jv = jrng.random_vec3(jnp.asarray(s))
    ts, tv = rng.random_vec3(torch.from_numpy(s.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())
    assert tv.shape == (64, 64, 3) and tv.dtype == torch.float32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=np.float32(2**-23))


@pytest.mark.parametrize("aspect", [None, 1.25])
def test_ray_dirs_matches_jax(aspect):
    """The (R, 3) form of the angle-linear rays, within 1e-6."""
    g = np.random.default_rng(4)
    u, v = g.uniform(size=(2, 3000)).astype(np.float32)
    jcam = j_make_camera(CAM_POS, CAM_DIR)
    ref = np.asarray(j_ray_dirs(jcam, jnp.asarray(u), jnp.asarray(v), 64, 48,
                                aspect=aspect))
    got = ray_dirs(make_camera(CAM_POS, CAM_DIR), torch.from_numpy(u),
                   torch.from_numpy(v), 64, 48, aspect=aspect)
    assert got.shape == (3000, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
