"""The whole slice: the torch ``Renderer`` on CPU (the kernels' plain
versions) against the JAX ``Renderer`` for every traversal name (its
Pallas kernels in interpret mode, as tests/test_subblock.py and
tests/test_pallas.py run them), and the ``"auto"`` rule.

Tolerance: RMSE < 1e-4, every value finite, and >= 99% of components
within 1e-4 relative.  The two programs round mul+add differently (XLA
contracts into FMAs), and an ulp can flip a grazing hit and diverge that
one path, as tests/test_shade.py allows.
"""

import numpy as np
import pytest

import opengl_raytracer_torch.models.scene as tscene_mod
from opengl_raytracer_tpu.models.rect import Rect as JRect
from opengl_raytracer_tpu.models.scene import Scene as JScene
from opengl_raytracer_tpu.models.trisoup import Triangles as JTriangles
from opengl_raytracer_tpu.ops.camera import make_camera as j_make_camera
from opengl_raytracer_tpu.renderer import Renderer as JRenderer
from opengl_raytracer_tpu.utils.config import RenderConfig as JRenderConfig

from opengl_raytracer_torch import (Rect, RenderConfig, Renderer, Scene,
                                    Triangles, make_camera)
from opengl_raytracer_torch.utils.image import rmse
from test_torch_scene import jax_native  # noqa: F401 (autouse)

CAM = (np.array([0, 0, 4.0], np.float32), (180.0, 0.0))


def _objects(rect_cls, tri_cls):
    rng = np.random.default_rng(2)
    tris = rng.uniform(-0.8, 0.8, (150, 3, 3)).astype(np.float32)
    return [
        rect_cls([4, 4, 0.1], [0, 0, -2], [0, 0, 0], color=[0.8, 0.2, 0.2],
                 roughness=1),
        rect_cls([4, 4, 0.1], [0, -2, 0], [90, 0, 0], color=[0.2, 0.8, 0.2],
                 roughness=1),
        rect_cls([1.5, 1.5, 0.1], [0, 1.9, 0], [90, 0, 0], color=[0, 0, 0],
                 emission_color=[1, 1, 1], emission=1.5, roughness=1),
        rect_cls([0.8, 0.8, 0.8], [1.2, -1.2, 0], [0, 30, 0],
                 color=[0.9, 0.9, 0.9], roughness=0),
        tri_cls(tris, color=(0.3, 0.3, 0.9), roughness=0.5),
    ]


@pytest.fixture(scope="module")
def scene():
    return Scene(_objects(Rect, Triangles))


def _render(scene, frames=2, **cfg):
    r = Renderer(scene, RenderConfig(width=16, height=16, bounces=2, **cfg),
                 device="cpu")
    return r.image(r.render(make_camera(*CAM), frames=frames))


def _assert_matches(ref, got):
    assert np.isfinite(got).all()
    assert rmse(ref, got) < 1e-4
    rel = np.abs(ref - got) / np.maximum(1.0, np.abs(ref))
    assert np.mean(rel > 1e-4) < 0.01
    assert got.mean() > 0.05  # lit, not black


def test_renderer_matches_jax_pallas2(scene):
    jr = JRenderer(JScene(_objects(JRect, JTriangles)),
                   JRenderConfig(width=16, height=16, bounces=2,
                                 traversal="pallas2"))
    ref = jr.image(jr.render(camera=j_make_camera(*CAM), frames=2))
    _assert_matches(ref, _render(scene))


def test_renderer_matches_jax_pallas2_two_samples(scene):
    """rays_per_pixel=2: the seed chains across the samples, so the
    integrator reorders with ``return_seed=True`` (a dead ray's seed moves
    too) and restores the seed; against the JAX Renderer's scan."""
    jr = JRenderer(JScene(_objects(JRect, JTriangles)),
                   JRenderConfig(width=16, height=16, bounces=2,
                                 traversal="pallas2", rays_per_pixel=2))
    ref = jr.image(jr.render(camera=j_make_camera(*CAM), frames=2))
    _assert_matches(ref, _render(scene, traversal="pallas2",
                                 rays_per_pixel=2))


def test_remainder_tiles_match_whole_frame(scene):
    """tile_size=3 on a 16x16 frame leaves remainder tiles (clamped band
    windows with masked merges); per-ray results do not depend on which
    rays share a batch, so the image equals the one-tile render."""
    whole = _render(scene)
    tiled = _render(scene, tile_size=3)
    np.testing.assert_allclose(tiled, whole, rtol=1e-6, atol=1e-7)


def test_frames_per_step_matches_sequential(scene):
    """frames_per_step=2 folds two frames' samples into one step; the
    running mean equals two sequential frames to float associativity."""
    seq = _render(scene, frames=4)
    batched = _render(scene, frames=4, frames_per_step=2)
    np.testing.assert_allclose(batched, seq, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("traversal", ["brute", "bvh", "packet", "pallas"])
def test_renderer_matches_jax(scene, traversal):
    """One frame of each other traversal against the JAX Renderer's:
    "packet" runs the packet walk's plain version here (the rays in 8x16
    blocks, as there) and the XLA packet traversal there, "pallas" the
    JAX wide kernel in interpret mode."""
    jr = JRenderer(JScene(_objects(JRect, JTriangles)),
                   JRenderConfig(width=16, height=16, bounces=2,
                                 traversal=traversal))
    ref = jr.image(jr.render(camera=j_make_camera(*CAM), frames=1))
    _assert_matches(ref, _render(scene, frames=1, traversal=traversal))


@pytest.mark.parametrize("cfg,frames", [
    (dict(width=24, bounces=4, lambertian=False), 2),
    (dict(aspect=1.25, sky_brightness=0.3, jitter_amount=0.01, tile_size=5),
     2),
    (dict(traversal="brute", rays_per_pixel=3), 1),
    (dict(traversal="pallas", frames_per_step=3, tile_size=2), 3),
], ids=["hemisphere_4_bounces", "aspect_sky_jitter_tiles",
        "brute_three_samples", "pallas_frames_per_step_3"])
def test_frame_matches_jax_configs(scene, cfg, frames):
    """Frames of four configurations against the JAX Renderer, at this
    module's tolerance: the hemisphere scatter over 5 segments at 24x16;
    a display aspect, a dim sky, a wide jitter and remainder tiles; brute
    force at 3 samples a pixel (the seed chains across samples); K3's plain
    version at 3 frames a step over 2x2 tiles.  "auto" runs "pallas2" in
    the port and the XLA packet walk in the JAX package off a TPU: per-ray
    results agree but for exact-t ties."""
    cfg = dict(dict(width=16, height=16, bounces=2), **cfg)
    jr = JRenderer(JScene(_objects(JRect, JTriangles)), JRenderConfig(**cfg))
    ref = jr.image(jr.render(camera=j_make_camera(*CAM), frames=frames))
    r = Renderer(scene, RenderConfig(**cfg), device="cpu")
    _assert_matches(ref, r.image(r.render(make_camera(*CAM), frames=frames)))


def _resolved(scene, traversal="auto"):
    return Renderer(scene, RenderConfig(width=16, height=16,
                                        traversal=traversal),
                    device="cpu").traversal


def test_auto_picks_brute_for_small_scenes():
    """At most 128 (padded) triangles: brute force, as in the JAX package."""
    objs = _objects(Rect, Triangles)[:4]  # 48 triangles
    assert _resolved(Scene(objs)) == "brute"
    jr = JRenderer(JScene(_objects(JRect, JTriangles)[:4]), JRenderConfig())
    assert jr.traversal == "brute"


def test_auto_picks_subblock_kernel(scene):
    assert len(scene.send("cpu").k1_parts) > 0
    assert _resolved(scene) == "pallas2"


def test_auto_picks_wide_kernel_without_subblock_tables(monkeypatch):
    """A scene past the sub-block builder's caps has no p2 tables; "auto"
    then runs K3, and an explicit "pallas2" refuses the scene."""
    def over_caps(*a, **k):
        raise ValueError("over the caps")

    monkeypatch.setattr(tscene_mod, "build_subblock_parts", over_caps)
    big = Scene(_objects(Rect, Triangles))
    assert len(big.send("cpu").k1_parts) == 0
    assert _resolved(big) == "pallas"
    r = Renderer(big, RenderConfig(width=16, height=16, bounces=2,
                                   traversal="pallas2"), device="cpu")
    with pytest.raises(ValueError, match="no sub-block tables"):
        r.render(make_camera(*CAM), frames=1)


def test_unpartitioned_scene_runs_brute_force():
    """build_bvh=False over 1024 triangles: a single giant leaf, which
    "auto" renders by brute force and every BVH traversal refuses."""
    g = np.random.default_rng(4)
    tris = g.uniform(-1, 1, (1100, 3, 3)).astype(np.float32)
    flat = Scene([Triangles(tris, color=(0.5, 0.5, 0.5))], build_bvh=False)
    assert _resolved(flat) == "brute"
    for traversal in ("bvh", "packet", "pallas", "pallas2"):
        with pytest.raises(ValueError, match="over 1024 triangles"):
            _resolved(flat, traversal)


def _recon_frame(scene, monkeypatch, recon: bool, frame_count=0, **cfg):
    """A 24x20 frame of the port (3 bounces, 2 frames), its reorders with
    (``recon``) or without seed reconstruction (``render_pixels``'s
    ``_seed_recon``); asserts which ran."""
    import opengl_raytracer_torch.renderer as rmod
    from opengl_raytracer_torch.ops import permute

    seen = []
    reorder, render_pixels = permute.reorder, rmod.render_pixels

    def spy(*args):
        seen.append(args[9] is not None)
        return reorder(*args)

    monkeypatch.setattr(permute, "reorder", spy)
    monkeypatch.setattr(rmod, "render_pixels", lambda *a, **k: render_pixels(
        *a, **k, _seed_recon=recon))
    r = Renderer(scene, RenderConfig(width=24, height=20, bounces=3, **cfg),
                 device="cpu")
    state = r.init_state()
    state.frame_count = frame_count
    img = r.image(r.render(make_camera(*CAM), frames=2, state=state))
    monkeypatch.undo()
    assert seen and set(seen) == {recon}
    return img


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(frames_per_step=2, ray_chunk=256, frame_count=2**32 - 2),
    dict(tile_size=7, traversal="pallas"),
], ids=["whole", "fps2_chunks_wrap", "remainder_tiles_k3"])
def test_seed_recon_frame_bit_identical(scene, monkeypatch, cfg):
    """A frame whose reorders rebuild the seed equals the same frame with
    the seed carried, bit for bit (the JAX package's
    tests/test_render.py:288-307): chunks with bases past 0 and padding
    rays (24x20 is not a whole number of 128-ray packets), frames_per_step
    2 at frame numbers that wrap past 2^32, remainder tiles."""
    cfg = dict(cfg)
    frame_count = cfg.pop("frame_count", 0)
    a = _recon_frame(scene, monkeypatch, True, frame_count, **cfg)
    b = _recon_frame(scene, monkeypatch, False, frame_count, **cfg)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert (a > 0).mean() > 0.5  # lit (the mean over 2^32 frames is tiny)


def test_seed_recon_frame_matches_jax(scene, monkeypatch):
    """The same 24x20 frame with seed reconstruction against the JAX
    Renderer's, whose "pallas2" step reconstructs the seed too (no 8x16
    block order there), at this module's tolerance."""
    jr = JRenderer(JScene(_objects(JRect, JTriangles)),
                   JRenderConfig(width=24, height=20, bounces=3,
                                 traversal="pallas2"))
    ref = jr.image(jr.render(camera=j_make_camera(*CAM), frames=2))
    _assert_matches(ref, _recon_frame(scene, monkeypatch, True))
