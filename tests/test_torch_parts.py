"""K1's part chain at its cap of 16 parts, on the CPU (plain versions).

A small Cornell scene of the benchmark's stand-ins (``rtbench/scenes.py``:
bumpy sphere, mirror ball, the seven boxes) has its sub-block tables split
into 16 parts by a small table budget, as the Happy Buddha's 1,087,716
triangles are split by the real one.  The port's ``Renderer`` renders it
and is held against the benchmark's plain reference
(``rtbench/reference/pathtrace.py``) under the ``buddha-converge`` cell's
limit; the 16-part chain's nearest hits are held against the same scene
in one part; the ``scene.subblock`` span reports the parts built.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_parts.py -q
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from opengl_raytracer_torch import RenderConfig, Renderer, make_camera  # noqa: E402
from opengl_raytracer_torch.models import scene as scene_mod  # noqa: E402
from opengl_raytracer_torch.ops import subblock_traversal as sbt  # noqa: E402
from opengl_raytracer_torch.ops.intersect import BIG, mt_single  # noqa: E402
from opengl_raytracer_torch.renderer import resolve_traversal  # noqa: E402
from opengl_raytracer_torch.utils import profiling  # noqa: E402
from rtbench import compare, harness, scenes, trace  # noqa: E402

# 2,452 triangles: the default budget keeps them in one part, this one
# splits them into 16 at the first round
BUDGET = 16 * 1024
RECIPE = {"dragon_cells": [24, 48], "dragon_triangles": 2300,
          "ball_cells": [4, 8]}


def small_budget(monkeypatch, budget: int = BUDGET) -> None:
    """Build every scene's sub-block tables under ``budget`` bytes a
    part."""
    orig = scene_mod.build_subblock_parts
    monkeypatch.setattr(scene_mod, "build_subblock_parts",
                        lambda *a, **k: orig(*a, **k, budget_bytes=budget))


def cornell(device="cpu"):
    """(objects, Scene, SceneData on ``device``, camera position, yaw and
    pitch) of the small scene, built as the benchmark builds a cell's."""
    return harness.build_scene({"scene": RECIPE}, trace.Spans(False), device)


def _subblock_span():
    got = [s for s in profiling.spans() if s.name == "scene.subblock"]
    assert got
    return got[-1]


def test_sixteen_part_render_matches_the_reference(monkeypatch):
    """The normal path: "auto" runs K1 over 16 parts, and 2 frames of 3
    bounces at 48x27 lie within the cell's limit of the reference."""
    small_budget(monkeypatch)
    objs, scene, data, pos, cam_dir = cornell()
    assert len(data.parts) == 16
    config = harness.load_json(os.path.join(harness.HERE, "configs",
                                             "cornell-buddha.json"))
    render = dict(config["render"], width=48, height=27, bounces=3)
    renderer = Renderer(scene, RenderConfig(**render), device="cpu")
    assert renderer.traversal == config["traversal"] == "pallas2"
    ov = sbt.overflow_tensor("cpu")
    ov.zero_()
    state = renderer.init_state()
    camera = make_camera(pos, cam_dir)
    for _ in range(2):
        state = renderer.step(state, camera)
    assert int(ov.item()) == 0

    check = harness.load_json(os.path.join(harness.HERE, "cells",
                                            "buddha-converge.json"))
    pixels = np.arange(48 * 27)
    answers = [dict(key=(tuple(pos), tuple(cam_dir), 2),
                    values=state.accum.view(-1, 3)[pixels].double().numpy())]
    (value, limit), = compare.check(answers, objs, render, check, pixels,
                                    "cpu").values()
    assert check["tau"] == 1e-3
    assert value <= limit, value


def _rays(R, seed=3):
    """Rays from inside the Cornell box in every direction, and an active
    mask."""
    g = np.random.default_rng(seed)
    lo, hi = np.asarray(scenes.BOX_LO), np.asarray(scenes.BOX_HI)
    o = (lo + (hi - lo) * g.uniform(0.05, 0.95, (R, 3))).astype(np.float32)
    d = g.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cols = (lambda x: tuple(torch.from_numpy(np.ascontiguousarray(x[:, a]))
                            for a in range(3)))
    active = torch.from_numpy(g.uniform(size=R) < 0.9)
    return cols(o), cols(d.astype(np.float32)), active


def test_sixteen_parts_hit_as_one(monkeypatch):
    """The chain over 16 parts against the same scene in one part: t bit
    for bit, the triangle the same but where two triangles tie at that
    exact t."""
    one = cornell()[2]
    small_budget(monkeypatch)
    sixteen = cornell()[2]
    assert (len(one.parts), len(sixteen.parts)) == (1, 16)
    for a in ("v0", "e1", "e2", "face"):  # one triangle order
        assert torch.equal(getattr(one, a), getattr(sixteen, a))

    o3, d3, active = _rays(4096)
    ov = sbt.overflow_tensor("cpu")
    ov.zero_()
    got = sbt.raycast_subblock(sixteen, o3, d3, active)
    ref = sbt.raycast_subblock(one, o3, d3, active)
    assert int(ov.item()) == 0
    assert torch.equal(got.t, ref.t)
    hit = got.t < BIG
    assert hit.sum() > active.sum() * 0.9  # the box closes the scene
    assert (got.t[~active] == BIG).all()

    tie = hit & (got.tri != ref.tri)
    assert tie.sum() < hit.sum() // 50
    if tie.any():
        o, d = tuple(x[tie] for x in o3), tuple(x[tie] for x in d3)
        for tri in (got.tri[tie].long(), ref.tri[tie].long()):
            valid, t, _, _ = mt_single(o, d, *(
                getattr(one, a)[tri].unbind(1)
                for a in ("v0", "e1", "e2", "face")))
            assert valid.all() and torch.equal(t, got.t[tie])
    same = hit & ~tie
    assert torch.equal(got.u[same], ref.u[same])
    assert torch.equal(got.v[same], ref.v[same])


def test_subblock_span_reports_the_parts(monkeypatch):
    small_budget(monkeypatch)
    fields = cornell()[1].fields()
    args = _subblock_span().args
    assert args["refused"] is False
    assert args["parts"] == 16 and args["rounds"] >= 1
    largest = max(r.nbytes + q.nbytes for r, q in [
        (fields["p2_node_rows"], fields["p2_tri_rows"]),
        *((n, q) for n, q, _ in fields["p2_extra"])])
    assert args["largest_part_bytes"] == largest <= BUDGET


def test_subblock_span_reports_a_refused_build(monkeypatch):
    """Under a budget no part fits, the build tries every split up to 16
    parts, then the scene keeps no sub-block tables and "auto" runs K3."""
    small_budget(monkeypatch, budget=2048)
    data = cornell()[2]
    args = _subblock_span().args
    assert args["refused"] is True and args["parts"] == 0
    assert args["rounds"] >= 1 and args["largest_part_bytes"] > 2048
    assert data.p2_node_rows.shape[0] == 0
    assert resolve_traversal(data, "auto") == "pallas"
