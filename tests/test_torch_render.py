"""The whole slice: the torch ``Renderer`` on CPU (plain versions of K1 and
K2) against the JAX ``Renderer(traversal="pallas2")`` (its Pallas kernels
in interpret mode, as tests/test_subblock.py runs it).

Tolerance: RMSE < 1e-4, every value finite, and >= 99% of components
within 1e-4 relative.  The two programs round mul+add differently (XLA
contracts into FMAs), and an ulp can flip a grazing hit and diverge that
one path, as tests/test_shade.py allows.
"""

import numpy as np
import pytest

from opengl_raytracer_tpu.models.rect import Rect as JRect
from opengl_raytracer_tpu.models.scene import Scene as JScene
from opengl_raytracer_tpu.models.trisoup import Triangles as JTriangles
from opengl_raytracer_tpu.ops.camera import make_camera as j_make_camera
from opengl_raytracer_tpu.renderer import Renderer as JRenderer
from opengl_raytracer_tpu.utils.config import RenderConfig as JRenderConfig

from opengl_raytracer_torch import (Rect, RenderConfig, Renderer, Scene,
                                    Triangles, make_camera)
from opengl_raytracer_torch.utils.image import rmse

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


def test_renderer_matches_jax_pallas2(scene):
    jr = JRenderer(JScene(_objects(JRect, JTriangles)),
                   JRenderConfig(width=16, height=16, bounces=2,
                                 traversal="pallas2"))
    ref = jr.image(jr.render(camera=j_make_camera(*CAM), frames=2))
    got = _render(scene)
    assert np.isfinite(got).all()
    assert rmse(ref, got) < 1e-4
    rel = np.abs(ref - got) / np.maximum(1.0, np.abs(ref))
    assert np.mean(rel > 1e-4) < 0.01
    assert got.mean() > 0.05  # lit, not black


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
def test_unported_traversals_raise(scene, traversal):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        Renderer(scene, RenderConfig(width=16, height=16,
                                     traversal=traversal), device="cpu")
