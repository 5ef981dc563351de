"""The Happy Buddha's configuration and its cell: the stand-in's triangle
count, the triangles it leaves out, and the files the harness finds by
the names ``BENCHMARK.json`` gives.

    python -m pytest rtbench/tests -q
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from rtbench import harness, scenes  # noqa: E402

TRIANGLES = 1_087_716 + 3_968 + 84  # the Buddha, the mirror ball, boxes
CHAIN = ("k1chain.later_parts_ms", "k1chain.g4_ms")
# the metrics of the layers the cell shares with the two other cells: all
# but K3's, which it never launches
SHARED = ("scene.build_s", "scene.bvh_s", "scene.subblock_s",
          "scene.tables_s", "scene.upload_s", "step.host_ms",
          "device.idle_share", "device.idle_block_ms",
          "device.idle_replay_ms", "device.idle_wait_ms",
          "device.idle_read_ms", "integrator.device_ms", "k1.device_ms",
          "k2_roofline")


@pytest.fixture(scope="module")
def config():
    return harness.load_json(os.path.join(harness.HERE, "configs",
                                          "cornell-buddha.json"))


def test_triangle_count(config):
    scene = config["scene"]
    assert scenes.triangle_count(scene) == scene["triangles"] == TRIANGLES
    objs, _, _ = scenes.build(scene)
    counts = [o["tris"].shape[0] for o in objs]
    assert counts[:2] == [1_087_716, 3_968] and sum(counts) == TRIANGLES


def test_the_dropped_triangles_lie_in_the_south_polar_row(config):
    """The stand-in is the first 1,087,716 of the bumpy sphere's 1,088,056
    triangles; the 340 left out have every corner on the last row of
    latitude or the south pole."""
    n_lat, n_lon = config["scene"]["dragon_cells"]
    whole = scenes.objects((n_lat, n_lon), config["scene"]["ball_cells"])[0]
    kept = scenes.build(config["scene"])[0][0]
    n = config["scene"]["dragon_triangles"]
    assert whole["tris"].shape[0] - n == 340
    np.testing.assert_array_equal(kept["tris"], whole["tris"][:n])
    np.testing.assert_array_equal(kept["normals"], whole["normals"][:n])
    dropped = whole["tris"][n:].reshape(-1, 3).astype(np.float64)
    rel = dropped - np.asarray([-5.0, -10.0, 0.0])  # the sphere's centre
    theta = np.arccos(np.clip(rel[:, 1] / np.linalg.norm(rel, axis=1), -1, 1))
    assert (theta >= np.pi * (n_lat - 1) / n_lat - 1e-4).all()


def test_cell_and_metric_files_are_found_by_name(config):
    bench = harness.benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == config["name"])
    assert entry["file"] == "rtbench/configs/cornell-buddha.json"
    assert entry["source"] == config["source"] and entry["reduced"] == []
    assert config["reduced"] == [] and config["traversal"] == "pallas2"
    cell = next(w for w in bench["workloads"]
                if w["name"] == "buddha-converge")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "cornell-buddha", "cli_converge", 1)
    check = harness.load_json(os.path.join(harness.HERE, "cells",
                                           "buddha-converge.json"))
    assert (check["pixels"], check["tau"]) == (4096, 1e-3)
    applies = {m["name"] for m in bench["per_layer"]
               if harness.applies(m, "buddha-converge")}
    assert applies == {*CHAIN, *SHARED}
    assert "k3.device_ms" not in applies
    for name in applies:
        assert callable(harness.load_module("metrics", name).read)
