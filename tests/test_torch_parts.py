"""K1's part chain at the JAX split's cap of 16 parts and at the card's
cap of 4, on the CPU (plain versions).

A small Cornell scene of the benchmark's stand-ins (``rtbench/scenes.py``:
bumpy sphere, mirror ball, the seven boxes) has its sub-block tables split
into 16 parts by a small table budget, or into 4 by four times that budget
and the card's cap, as the Happy Buddha's 1,087,716 triangles are split
by the real ones.  The port's ``Renderer`` renders it and is held against
the benchmark's plain reference (``rtbench/reference/pathtrace.py``) under
the ``buddha-converge`` cell's limit; the chain's nearest hits are held
against the same scene in one part; ``Scene`` builds at the card's budget
and the ``scene.subblock`` span reports the parts built and the split.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_parts.py -q
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from opengl_raytracer_torch import RenderConfig, Renderer, make_camera  # noqa: E402
from opengl_raytracer_torch.models import scene as scene_mod  # noqa: E402
from opengl_raytracer_torch.ops import subblock_traversal as sbt  # noqa: E402
from opengl_raytracer_torch.ops import wide2  # noqa: E402
from opengl_raytracer_torch.ops.intersect import (  # noqa: E402
    BIG, mt_single, unpack_tri_records)
from opengl_raytracer_torch.renderer import resolve_traversal  # noqa: E402
from opengl_raytracer_torch.utils import profiling  # noqa: E402
from rtbench import compare, harness, scenes, trace  # noqa: E402

# 2,448 triangles: the default budget keeps them in one part, this one
# splits them into 16 at the first round, four times it with a cap of 4
# parts (the card's budget to the JAX one, and the card's cap) into 4, and
# eight times it with a cap of 2 into 2
BUDGET = 16 * 1024
SPLITS = {16: (BUDGET, 16), 4: (4 * BUDGET, wide2.CARD_MAX_PARTS),
          2: (8 * BUDGET, 2)}
RECIPE = {"dragon_cells": [24, 48], "dragon_triangles": 2300,
          "ball_cells": [4, 8]}


def small_budget(monkeypatch, budget: int = BUDGET,
                 max_parts: int = 16) -> None:
    """Build every scene's sub-block tables under ``budget`` bytes and
    ``max_parts`` parts, in place of the card's budget and cap that
    ``Scene`` passes."""
    orig = scene_mod.build_subblock_parts
    monkeypatch.setattr(scene_mod, "build_subblock_parts",
                        lambda *a, **k: orig(*a, **{
                            **k, "budget_bytes": budget,
                            "max_parts": max_parts}))


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
    assert len(data.k1_parts) == 16
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


@pytest.mark.parametrize("n_parts", sorted(SPLITS))
def test_sixteen_parts_hit_as_one(monkeypatch, n_parts):
    """The chain over 16 parts, over 4 and over 2, against the same scene
    in one part: t bit for bit, the triangle the same but where two
    triangles tie at that exact t."""
    one = cornell()[2]
    small_budget(monkeypatch, *SPLITS[n_parts])
    sixteen = cornell()[2]
    assert (len(one.k1_parts), len(sixteen.k1_parts)) == (1, n_parts)
    # one triangle order
    assert torch.equal(one.tri_records, sixteen.tri_records)

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
                x[tri].unbind(1) for x in unpack_tri_records(one.tri_records)))
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
    assert (args["budget_bytes"], args["max_parts"]) == (BUDGET, 16)


def test_subblock_span_reports_a_refused_build(monkeypatch):
    """Under a budget no part fits, the build tries every split up to 16
    parts, then the scene keeps no sub-block tables and "auto" runs K3."""
    small_budget(monkeypatch, budget=2048)
    data = cornell()[2]
    args = _subblock_span().args
    assert args["refused"] is True and args["parts"] == 0
    assert args["rounds"] >= 1 and args["largest_part_bytes"] > 2048
    assert (args["budget_bytes"], args["max_parts"]) == (2048, 16)
    assert len(data.k1_parts) == 0
    assert resolve_traversal(data, "auto") == "pallas"


def test_scene_splits_at_the_cards_budget(monkeypatch):
    """``Scene.fields`` builds its sub-block tables at the card's budget
    and part cap, and its span reports them.  minidragon-converge's scene
    fits one part under that budget and under the JAX package's, so its
    tables are the JAX split's bit for bit."""
    calls = []
    orig = scene_mod.build_subblock_parts

    def recorded(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    monkeypatch.setattr(scene_mod, "build_subblock_parts", recorded)
    config = harness.load_json(os.path.join(harness.HERE, "configs",
                                             "cornell-minidragon.json"))
    scene, data = harness.build_scene(config, trace.Spans(False), "cpu")[1:3]
    (args, kw), = calls
    assert (kw["budget_bytes"], kw["max_parts"]) == (
        wide2.CARD_TABLE_BUDGET_BYTES, wide2.CARD_MAX_PARTS) == (
        31_457_280, 4)
    span = _subblock_span().args
    assert (span["parts"], span["budget_bytes"], span["max_parts"]) == (
        1, 31_457_280, 4)
    assert args[0].shape[0] == 27_542
    jax_split = wide2.build_subblock_parts(*args)  # the JAX defaults
    fields = scene.fields()
    parts = [(fields["p2_node_rows"], fields["p2_tri_rows"],
              fields["p2_remap"]), *fields["p2_extra"]]
    assert len(jax_split) == len(parts) == len(data.k1_parts) == 1
    for got, ref in zip(parts[0], jax_split[0]):
        assert np.array_equal(np.asarray(got).view(np.uint32),
                              np.asarray(ref).view(np.uint32))


def test_refusal_builds_no_part(monkeypatch):
    """A split whose parts cannot fit is refused before any part is
    built: the Asian Dragon's 7,223,097 triangles at the card's budget
    (4 parts of 1.8M triangles, each at least 115 MB of octet rows), on
    inputs that hold no memory, and the small scene's 4 parts of 612
    under 16 KB; the span reports the least bytes of the first part."""
    built = []
    orig = wide2.build_subblock
    monkeypatch.setattr(wide2, "build_subblock",
                        lambda *a, **k: built.append(1) or orig(*a, **k))
    T = 7_223_097
    tri = np.broadcast_to(np.zeros(3, np.float32), (T, 3))
    stats = {}
    with pytest.raises(ValueError):
        wide2.build_subblock_parts(
            tri, tri, tri, np.broadcast_to(np.zeros(16, np.float32), (T, 16)),
            budget_bytes=wide2.CARD_TABLE_BUDGET_BYTES,
            max_parts=wide2.CARD_MAX_PARTS, stats=stats)
    assert stats == dict(parts=0, rounds=1,
                         largest_part_bytes=(225_728 + 8) * 512,
                         budget_bytes=31_457_280, max_parts=4)

    small_budget(monkeypatch, BUDGET, wide2.CARD_MAX_PARTS)
    data = cornell()[2]
    args = _subblock_span().args
    assert args["refused"] is True and len(data.k1_parts) == 0
    assert (args["rounds"], args["largest_part_bytes"]) == (
        1, (80 + 8) * 512)
    assert not built
