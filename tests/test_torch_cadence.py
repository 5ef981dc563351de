"""The reorder cadence (``RenderConfig.sort_every``) and the leaf bound
(``RenderConfig.max_leaf_tris``) in the port, against the JAX package.

The integrator sorts the rays before bounce segment ``i`` only when ``i >=
1`` and ``(i - 1) % sort_every == 0`` (``opengl_raytracer_tpu/ops/
integrator.py:209``).  A skipped segment traverses the rays one sort
stale, the dead among the live; the reorder and the restore are
permutations carrying all per-ray state, so the frame is the same at any
cadence.

Tolerances: a frame at any cadence equals the frame at cadence 1 bit for
bit (the kernels' plain versions here); against the JAX ``Renderer`` at
the same cadence, tests/test_torch_render.py's (rmse < 1e-4, >= 99% of
components within 1e-4 relative); a (2, 2) mesh equals the sequential
``Renderer`` bit for bit, as tests/test_torch_sharding.py holds
"pallas2"; the config and the leaf bound field for field.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import opengl_raytracer_tpu.ops.morton as jmorton
from opengl_raytracer_tpu.app import App as JApp
from opengl_raytracer_tpu.models.rect import Rect as JRect
from opengl_raytracer_tpu.models.scene import Scene as JScene
from opengl_raytracer_tpu.models.trisoup import Triangles as JTriangles
from opengl_raytracer_tpu.ops.camera import make_camera as j_make_camera
from opengl_raytracer_tpu.ops.integrator import raytrace as j_raytrace
from opengl_raytracer_tpu.renderer import Renderer as JRenderer
from opengl_raytracer_tpu.renderer import make_raycast_fn as j_raycast_fn
from opengl_raytracer_tpu.utils.config import RenderConfig as JRenderConfig

import opengl_raytracer_torch.renderer as rmod
from opengl_raytracer_torch import (Rect, RenderConfig, Renderer, Scene,
                                    Triangles, make_camera)
from opengl_raytracer_torch.app import App
from opengl_raytracer_torch.ops import permute
from opengl_raytracer_torch.parallel import ShardedRenderer, make_mesh
from opengl_raytracer_torch.renderer import (effective_max_leaf,
                                             resolve_leaf_bound)
from test_torch_render import CAM, _assert_matches, _objects
from test_torch_scene import jax_native  # noqa: F401 (autouse)

CADENCES = (2, 3, 4, 7)
# Each variant: the config's fields and whether the reorders rebuild the
# seed (render_pixels's _seed_recon; the main path at one sample a pixel)
VARIANTS = {
    "pallas2": (dict(traversal="pallas2"), True),
    "pallas": (dict(traversal="pallas"), True),
    "pallas2_carried_seed": (dict(traversal="pallas2"), False),
    "pallas_carried_seed": (dict(traversal="pallas"), False),
    "pallas2_two_samples": (dict(traversal="pallas2", rays_per_pixel=2),
                            True),
    "pallas_frames_per_step_2": (dict(traversal="pallas", frames_per_step=2),
                                 True),
}


@pytest.fixture(scope="module")
def scene():
    return Scene(_objects(Rect, Triangles))


def _frame(scene, monkeypatch, variant, sort_every):
    """Two 24x20 frames of 4 bounces (5 segments) of ``variant`` at
    ``sort_every``; returns accum and the reorders each made, by whether
    it rebuilt the seed."""
    cfg, recon = VARIANTS[variant]
    seen = []
    reorder, render_pixels = permute.reorder, rmod.render_pixels

    def spy(*args):
        seen.append(args[9] is not None)
        return reorder(*args)

    monkeypatch.setattr(permute, "reorder", spy)
    monkeypatch.setattr(rmod, "render_pixels", lambda *a, **k: render_pixels(
        *a, **k, _seed_recon=recon))
    r = Renderer(scene, RenderConfig(width=24, height=20, bounces=4,
                                     sort_every=sort_every, **cfg),
                 device="cpu")
    state = r.render(make_camera(*CAM), frames=2)
    monkeypatch.undo()
    return state.accum, seen


@pytest.fixture(scope="module")
def cadence_one():
    """Each variant's frame at cadence 1, made once for the module."""
    return {}


@pytest.mark.parametrize("sort_every", CADENCES)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_frame_equals_cadence_one(scene, cadence_one, monkeypatch, variant,
                                  sort_every):
    """accum at ``sort_every`` equals accum at 1 bit for bit, with the
    cadence's reorders: ``n_bounces - 1`` a raytrace at 1, fewer here."""
    if variant not in cadence_one:
        cadence_one[variant] = _frame(scene, monkeypatch, variant, 1)
    ref, ref_seen = cadence_one[variant]
    got, seen = _frame(scene, monkeypatch, variant, sort_every)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert float(got.mean()) > 0.05
    sorts = len([i for i in range(1, 5) if (i - 1) % sort_every == 0])
    assert len(seen) * 4 == len(ref_seen) * sorts
    recon = VARIANTS[variant][1] and "two_samples" not in variant
    assert set(seen) == set(ref_seen) == {recon}


@pytest.mark.parametrize("sort_every", [2, 4])
@pytest.mark.parametrize("traversal", ["pallas2", "pallas"])
def test_cadence_matches_jax(scene, traversal, sort_every):
    """The port and the JAX Renderer at the same cadence (the JAX kernels
    in interpret mode), 16x16 at 3 bounces: cadence 2 sorts before
    segments 1 and 3, cadence 4 before segment 1 only."""
    cfg = dict(width=16, height=16, bounces=3, traversal=traversal,
               sort_every=sort_every)
    jr = JRenderer(JScene(_objects(JRect, JTriangles)), JRenderConfig(**cfg))
    ref = jr.image(jr.render(camera=j_make_camera(*CAM), frames=1))
    r = Renderer(scene, RenderConfig(**cfg), device="cpu")
    _assert_matches(ref, r.image(r.render(make_camera(*CAM), frames=1)))


def _jax_sorts(jdata, n_bounces, sort_every):
    """The coherence sorts the JAX raytrace makes, counted while it is
    traced (its bounce loop unrolls)."""
    calls = []
    keys = jmorton.ray_sort_keys_soa

    def spy(*args, **kw):
        calls.append(1)
        return keys(*args, **kw)

    cfg = JRenderConfig(width=16, height=8, traversal="brute")
    raycast = j_raycast_fn(jdata, cfg, "brute")
    R = 128
    o = tuple(np.full(R, c, np.float32) for c in CAM[0])
    d = tuple(np.full(R, c, np.float32) for c in (0.0, 0.0, -1.0))
    seed = np.arange(R, dtype=np.uint32)
    sky = np.ones(3, np.float32)
    jmorton.ray_sort_keys_soa = spy
    try:
        jax.make_jaxpr(lambda: j_raytrace(
            jdata, raycast, o, d, seed, sky, n_bounces, True, reorder=True,
            sort_every=sort_every, return_seed=False))()
    finally:
        jmorton.ray_sort_keys_soa = keys
    return len(calls)


@pytest.fixture(scope="module")
def jdata():
    return JScene(_objects(JRect, JTriangles)).send()


@pytest.mark.parametrize("sort_every", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n_bounces", [1, 2, 3, 4, 5, 6])
def test_reorders_per_raytrace_follow_jax(scene, jdata, monkeypatch,
                                          n_bounces, sort_every):
    """The port's ``permute.reorder`` calls in one frame (one chunk, one
    sample: one raytrace) equal the JAX raytrace's sorts."""
    calls = []
    reorder = permute.reorder
    monkeypatch.setattr(permute, "reorder",
                        lambda *a: calls.append(1) or reorder(*a))
    r = Renderer(scene, RenderConfig(width=16, height=8,
                                     bounces=n_bounces - 1,
                                     traversal="pallas",
                                     sort_every=sort_every), device="cpu")
    r.render(make_camera(*CAM), frames=1)
    assert len(calls) == _jax_sorts(jdata, n_bounces, sort_every)


@pytest.mark.parametrize("traversal", ["pallas2", "pallas"])
def test_mesh_at_cadence_two_equals_sequential(scene, traversal):
    """A (2, 2) mesh of the CPU at sort_every=2 equals the sequential
    Renderer at the same cadence (and so at cadence 1)."""
    cfg = dict(width=16, height=16, bounces=4, traversal=traversal)
    sr = ShardedRenderer(scene, RenderConfig(sort_every=2, **cfg),
                         make_mesh(devices=["cpu"] * 4, dp=2, sp=2))
    got = sr.image(sr.render(make_camera(*CAM), frames=2))
    for k in (2, 1):
        r = Renderer(scene, RenderConfig(sort_every=k, **cfg), device="cpu")
        np.testing.assert_array_equal(
            got, r.image(r.render(make_camera(*CAM), frames=2)))
    assert sr.config.sort_every == 2


# ------------------------------------------------------ the config

@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(JRenderConfig)])
def test_config_field_matches_jax(field):
    """Every field of the JAX RenderConfig, in its order, with its
    default."""
    names = [f.name for f in dataclasses.fields(RenderConfig)]
    jnames = [f.name for f in dataclasses.fields(JRenderConfig)]
    assert names == jnames
    assert getattr(RenderConfig(), field) == getattr(JRenderConfig(), field)


@pytest.mark.parametrize("asked", [1, 8, 32, 64])
def test_renderers_keep_the_resolved_config(scene, asked):
    """Renderer and ShardedRenderer keep ``resolve_leaf_bound``'s config:
    the JAX Renderer's, field for field."""
    cfg = dict(width=16, height=16, max_leaf_tris=asked, sort_every=3)
    jr = JRenderer(JScene(_objects(JRect, JTriangles)), JRenderConfig(**cfg))
    r = Renderer(scene, RenderConfig(**cfg), device="cpu")
    sr = ShardedRenderer(scene, RenderConfig(**cfg),
                         make_mesh(devices=["cpu"], dp=1, sp=1))
    leaf = effective_max_leaf(r.scene)
    for got in (r.config, sr.config,
                resolve_leaf_bound(r.scene, RenderConfig(**cfg))):
        assert dataclasses.asdict(got) == dataclasses.asdict(jr.config)
        assert got.max_leaf_tris == leaf and got.sort_every == 3


@pytest.mark.parametrize("leaf", [None, 8, 64])
def test_app_config_leaf_bound_matches_jax(leaf):
    """App puts ``max_leaf_tris`` into its config when given one, as the
    JAX App does; its renderer's config holds the scene's own bound."""
    from test_torch_app import tiny_scene

    kw = dict(window_size=(16, 16), bounces=1, headless=True, run=False,
              max_leaf_tris=leaf)
    japp = JApp(scene=tiny_scene(JRect, JScene), **kw)
    app = App(scene=tiny_scene(), device="cpu", **kw)
    assert dataclasses.asdict(app.config) == dataclasses.asdict(japp.config)
    assert (dataclasses.asdict(app.renderer.config)
            == dataclasses.asdict(japp.renderer.config))


@pytest.mark.parametrize("leaf", [4, 16])
def test_cli_passes_the_leaf_bound(tmp_path, monkeypatch, leaf):
    """The CLI's mesh path gives ``--leaf`` to its RenderConfig (the JAX
    CLI's ``__main__.py:130``) and to the scene it builds."""
    import opengl_raytracer_torch.parallel.sharding as smod
    from opengl_raytracer_torch.__main__ import main
    from test_torch_obj import write_latlong_obj

    seen = []

    class Spy(smod.ShardedRenderer):
        def __init__(self, scene, config, mesh):
            seen.append((scene, config))
            super().__init__(scene, config, mesh)

    monkeypatch.setattr(smod, "ShardedRenderer", Spy)
    obj = write_latlong_obj(tmp_path / "ball" / "ball.obj", 10, 10,
                            radius=3.0)
    assert main(["--width", "16", "--height", "8", "--bounces", "1",
                 "--obj", obj, "--frames", "1", "--leaf", str(leaf),
                 "--dp", "1", "--sp", "1", "--device", "cpu",
                 "--out", str(tmp_path / "t.png")]) == 0
    (scene, config), = seen
    assert config.max_leaf_tris == leaf and scene.max_leaf_tris == leaf
