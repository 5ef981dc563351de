"""The ``app_fly`` loop (``rtbench/loops/fly.py``) on the CPU at a tiny
size (32x18 pixels, a 404-triangle scene, cycles of 4 frames): what a run
imports, that its answers score under ``compare.check`` and the control's
do not, and that the loop refuses shown bytes that are not ``to_uint8``
of the frame.  A run with a window of 0 s ends on its first answer whose
bytes were shown, so no test depends on how fast the CPU is.

    python -m pytest rtbench/tests -q
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from rtbench import compare, harness  # noqa: E402
from rtbench.tests.test_rtbench_runs import SEED, TINY, _loaded  # noqa: E402

FLY = dict(TINY, traffic={"frames_per_cycle": 4, "moving_frames": 2})


def test_a_fly_run_loads_neither_jax_nor_pygame():
    code = (f"from rtbench import harness\n"
            f"res = harness.run_cell('minidragon-fly', {SEED}, 0.0, True, "
            f"device='cpu', overrides={FLY!r})\n"
            f"assert res['correct'] and res['attempted'] == 2, res\n")
    loaded = _loaded(code)
    assert "opengl_raytracer_torch" in loaded
    assert not loaded & {"pygame", *harness.FORBIDDEN}


def test_fly_program_passes_and_control_fails():
    res = harness.run_cell("minidragon-fly", SEED, 0.0, False, device="cpu",
                           overrides=FLY, control=torch.bfloat16)
    limit = res["compared"]["bad_pixels_pct"]["limit"]
    assert res["correct"], res["compared"]
    assert res["control"]["bad_pixels_pct"] > limit, res
    assert set(res["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}


def test_fly_refuses_shown_bytes_that_are_not_the_frame(monkeypatch):
    from opengl_raytracer_torch.ops import display
    plain = display.to_uint8_plain
    monkeypatch.setattr(display, "to_uint8_plain",
                        lambda img: plain(img) ^ 1)
    with pytest.raises(RuntimeError, match="bytes shown differ"):
        harness.run_cell("minidragon-fly", SEED, 0.0, False, device="cpu",
                         overrides=FLY)


def _config(cell: str) -> dict:
    """The configuration file of ``cell``, as the harness finds it."""
    name = next(w["config"] for w in harness.benchmark()["workloads"]
                if w["name"] == cell)
    return harness.load_json(os.path.join(harness.HERE, "configs",
                                          name + ".json"))


def test_fly_config_is_the_apps_defaults():
    """The App's configuration states the settings the run uses: the
    default scene and render of the CLI's configuration, which are the
    App's constructor defaults, and the App's own speed and sensitivity,
    with ``canMove`` on as the loop sets it."""
    import inspect

    from opengl_raytracer_torch.app import App
    from rtbench import scenes

    app, cli = _config("minidragon-fly"), _config("minidragon-converge")
    assert app["name"] != cli["name"] and app["source"] != cli["source"]
    assert app["reduced"] == []
    for key in ("scene", "render", "traversal", "precision"):
        assert app[key] == cli[key], key
    assert scenes.triangle_count(app["scene"]) == app["scene"]["triangles"]
    defaults = {k: v.default for k, v in
                inspect.signature(App.__init__).parameters.items()}
    render = app["render"]
    assert defaults["window_size"] == (render["width"], render["height"])
    for arg, key in (("bounces", "bounces"),
                     ("rays_per_pixel", "rays_per_pixel"),
                     ("jitter_amount", "jitter_amount"),
                     ("lambertian", "lambertian"),
                     ("skyIllumination", "sky_brightness"),
                     ("tileSize", "tile_size")):
        assert defaults[arg] == render[key], arg
    a = App(window_size=(8, 6), scene=_tiny_scene(), headless=True,
            run=False, device="cpu")
    assert (a.speed, a.sensitivity) == (app["app"]["speed"],
                                        app["app"]["sensitivity"])
    assert app["app"]["canMove"] is True


def _tiny_scene():
    from opengl_raytracer_torch import Scene, Triangles
    from rtbench import scenes

    objs, _, _ = scenes.build(TINY["scene"])
    return Scene([Triangles(o["tris"], o["normals"], color=o["color"],
                            emission_color=o["emission_color"],
                            emission=o["emission"], roughness=o["roughness"])
                  for o in objs])


class _Run:
    def __init__(self):
        self.frames = []


def test_fly_answers_each_cycle_and_the_first_moves():
    """Three cycles of 4 frames: the one-frame answers of the first cycle
    of each direction (2 each) and each cycle's still pose after 3 frames,
    all shown but the last, scoring under ``compare.check``; the poses go
    forward turning right, then back turning left, then again."""
    from rtbench import trace

    config = _config("minidragon-fly")
    config["scene"].update(FLY["scene"])
    config["render"].update(FLY["render"])
    spans = trace.Spans(profiled=False)
    objs, scene, _, pos, cam_dir = harness.build_scene(config, spans, "cpu")
    pixels = harness.sample_pixels(32, 18, 200, SEED)
    params = dict(harness.load_json(os.path.join(
        harness.HERE, "traffic", "app_fly.json")), **FLY["traffic"])
    loop = harness.load_module("loops", "fly").Loop(
        scene=scene, render=config["render"], cam_pos=pos, cam_dir=cam_dir,
        params=params, pixels=pixels, spans=spans, device="cpu")
    loop.setup()
    loop._run = run = _Run()
    for j in range(12):
        loop.frame(j)
    assert len(run.frames) == 12  # the first presents the warm-up's frame
    answers = loop.answers()
    assert [a["key"][2] for a in answers] == [1, 1, 3, 1, 1, 3, 3]
    assert sorted(loop.shown_bytes) == [0, 1, 2, 3, 4, 5]
    yaws = [a["key"][1][0] for a in answers]
    assert yaws[0] == np.float32(cam_dir[0]) + np.float32(2.0)
    assert yaws[1] == yaws[0] + 2.0 and yaws[2] == yaws[1]
    assert yaws[3] == yaws[2] - 2.0 and yaws[4] == yaws[3] - 2.0
    assert yaws[6] == yaws[2] and answers[6]["key"] != answers[2]["key"]
    check = harness.load_json(os.path.join(harness.HERE, "cells",
                                           "minidragon-fly.json"))
    check["pixels"] = 200
    got = compare.check(answers, objs, config["render"], check, pixels,
                        "cpu")
    assert got["bad_pixels_pct"][0] <= got["bad_pixels_pct"][1], got
