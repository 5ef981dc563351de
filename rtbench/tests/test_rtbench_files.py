"""The benchmark's files: the frozen stand-in scene against the one
``chip_smoke.py`` times, ``BENCHMARK.json`` against the contract's
characters and against the files it names, and the harness finding a
metric by its file alone.

    python -m pytest rtbench/tests -q
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from rtbench import harness, scenes  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


@pytest.mark.parametrize("cells", [((8, 16), (32, 64)), ((5, 9), (32, 64)),
                                   ((81, 145), (32, 64))])
def test_standins_match_chip_smoke(cells):
    """Triangle for triangle, normal for normal and material for material,
    the frozen copy gives ``chip_smoke.standin_objects``' scene."""
    import chip_smoke

    ours = scenes.objects(*cells)
    theirs = chip_smoke.standin_objects(*cells[0])
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a["tris"].reshape(-1, 3), b.pos)
        np.testing.assert_array_equal(a["normals"].reshape(-1, 3), b.normals)
        np.testing.assert_array_equal(np.float32(a["color"]),
                                      np.float32(b.color))
        np.testing.assert_array_equal(np.float32(a["emission_color"]),
                                      np.float32(b.emission_color))
        assert a["emission"] == b.emission and a["roughness"] == b.roughness


@pytest.mark.parametrize("config,count", [("cornell-minidragon", 27_542),
                                          ("cornell-asiandragon", 7_223_097)])
def test_config_triangles(config, count):
    cfg = harness.load_json(os.path.join(harness.HERE, "configs",
                                         config + ".json"))
    assert scenes.triangle_count(cfg["scene"]) == count
    assert cfg["scene"]["triangles"] == count


@pytest.mark.parametrize("cfg", [
    {"dragon_cells": [8, 16], "ball_cells": [4, 8]},
    {"dragon_cells": [8, 16], "dragon_triangles": 251, "ball_cells": [4, 8]}])
def test_every_run_renders_one_scene_from_one_pose(cfg):
    objs, pos, cam_dir = scenes.build(cfg)
    assert sum(o["tris"].shape[0] for o in objs) == scenes.triangle_count(cfg)
    assert pos == scenes.CAM_POS and cam_dir == scenes.CAM_DIR
    assert all(lo < p < hi for p, lo, hi in
               zip(pos, scenes.BOX_LO, scenes.BOX_HI))


def test_names_and_units(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = ([m["name"] for m in metrics]
             + [c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [w["config"] for w in bench["workloads"]]
             + [w["traffic"] for w in bench["workloads"]]
             + [k for c in bench["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for w in bench["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in bench["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
    assert len(json.dumps(bench)) < 64 * 1024


def test_moves_is_reported_by_each_cell(bench):
    """Every per-layer metric moves an end-to-end metric that each of its
    cells reports."""
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        e2e = [e for e in bench["end_to_end"] if e["name"] == m["moves"]]
        assert e2e, m
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert harness.applies(e2e[0], cell)


@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark()[
    "workloads"]])
def test_each_cell_reports_enough(bench, cell):
    """``setup_s``, another end-to-end metric and a per-layer one."""
    e2e = {m["name"] for m in bench["end_to_end"] if harness.applies(m, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(harness.applies(m, cell) for m in bench["per_layer"])


def test_every_name_has_its_file(bench):
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        traffic = harness.load_json(os.path.join(
            harness.HERE, "traffic", w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(harness.HERE, "loops",
                                           traffic["loop"] + ".py"))
        check = harness.load_json(os.path.join(harness.HERE, "cells",
                                               w["name"] + ".json"))
        assert set(check["limits"]) == {"bad_pixels_pct"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = harness.load_module("metrics", m["name"])
        assert mod.SOURCE == m["source"] and mod.UNIT == m["unit"]
        assert getattr(mod, "LAYER", None) == m.get("layer")
        assert getattr(mod, "MOVES", None) == m.get("moves")


def test_a_metric_file_is_found_by_its_name(bench, tmp_path, monkeypatch):
    """A new per-layer metric is a file and an entry: the harness reads it
    with no other edit."""
    tree = tmp_path / "rtbench"
    shutil.copytree(harness.HERE, tree,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tree / "metrics" / "dummy.frames.py").write_text(
        "SOURCE, UNIT, LAYER, MOVES = 'program_counter', 'frames', "
        "'Device', 'frame_ms'\n\n\ndef read(run):\n"
        "    return float(run.n_frames)\n")
    entry = {"name": "dummy.frames", "unit": "frames", "better": "higher",
             "source": "program_counter", "layer": "Device",
             "moves": "frame_ms", "workloads": ["minidragon-converge"]}
    bench = dict(bench, per_layer=bench["per_layer"] + [entry])
    monkeypatch.setattr(harness, "HERE", str(tree))
    from rtbench import trace

    run = harness.Run({}, trace.Spans(False), 0.0)
    run.frames = [1.0, 2.0, 3.0]
    got = harness.read_metrics(bench, "minidragon-converge", True, run)
    assert got["dummy.frames"] == {"value": 3.0, "unit": "frames"}
    assert "dummy.frames" not in harness.read_metrics(
        bench, "asiandragon-converge", True, run)
