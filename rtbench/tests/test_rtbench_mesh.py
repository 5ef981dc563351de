"""The ``cli_converge_mesh`` loop (``rtbench/loops/mesh.py``) and the mesh
step's readers (``rtbench/metrics/mesh.*``) on the CPU: a tiny run of
``minidragon-mesh4`` (32x16 pixels, so that dp 4 divides the rows, a
404-triangle scene, jobs of 2 frames, the CPU four times) imports no JAX,
scores under ``compare.check`` and its control does not; the loop refuses
a window whose steps copied between devices; the readers on synthetic
spans.  A run with a window of 0 s ends on its first finished job, so no
test depends on how fast the CPU is.

    python -m pytest rtbench/tests -q
"""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from rtbench import harness, trace  # noqa: E402
from rtbench.tests.test_rtbench_runs import SEED, TINY, _loaded  # noqa: E402

MESH = dict(TINY, render={"width": 32, "height": 16},
            traffic={"frames_per_job": 2})


def test_a_mesh_run_loads_no_jax_and_passes_where_the_control_fails():
    code = (f"import torch\n"
            f"from rtbench import harness\n"
            f"res = harness.run_cell('minidragon-mesh4', {SEED}, 0.0, False,"
            f" device='cpu', overrides={MESH!r}, control=torch.bfloat16)\n"
            f"lim = res['compared']['bad_pixels_pct']['limit']\n"
            f"assert res['correct'] and res['attempted'] == 2, res\n"
            f"assert res['control']['bad_pixels_pct'] > lim, res\n"
            f"assert set(res['metrics']) == {{'frame_ms', 'frame_ms_p95', "
            f"'setup_s'}}, res\n")
    loaded = _loaded(code)
    assert "opengl_raytracer_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_mesh_cell_is_the_default_render_on_four_cards():
    """The configuration is cornell-minidragon's scene and render with the
    mesh (dp 4, sp 1) added, cut nowhere; the cell takes four chips; its
    check is minidragon-converge's; the mesh's readers and the readers of
    the layers it shares with the one-card cells apply, the device idle
    readers (the union of the cards' kernels) do not."""
    bench = harness.benchmark()
    cell = next(w for w in bench["workloads"]
                if w["name"] == "minidragon-mesh4")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "cornell-minidragon-mesh4", "cli_converge_mesh", 4)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) == 1
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    mesh = harness.load_json(os.path.join(ROOT, entry["file"]))
    one = harness.load_json(os.path.join(harness.HERE, "configs",
                                         "cornell-minidragon.json"))
    assert entry["reduced"] == mesh["reduced"] == []
    assert entry["source"] == mesh["source"] and len(entry["source"]) <= 200
    render = dict(mesh["render"])
    assert render.pop("mesh") == {"dp": 4, "sp": 1}
    assert render == one["render"] and mesh["scene"] == one["scene"]
    for key in ("traversal", "precision"):
        assert mesh[key] == one[key]
    check, one_check = (harness.load_json(os.path.join(
        harness.HERE, "cells", name + ".json"))
        for name in ("minidragon-mesh4", "minidragon-converge"))
    assert check == one_check
    applies = {m["name"] for m in bench["per_layer"]
               if harness.applies(m, "minidragon-mesh4")}
    assert applies == {"mesh.straggler_ms", "mesh.fold_host_ms",
                       "scene.build_s", "scene.bvh_s", "scene.subblock_s",
                       "scene.tables_s", "scene.upload_s", "step.host_ms",
                       "integrator.device_ms", "k1.device_ms", "k2_roofline"}


class _Run:
    def __init__(self, traced=None):
        self.frames, self.traced, self.t_open = [], traced, 0.0


def _loop(device="cpu", **traffic):
    """The mesh loop over the tiny scene, under "bvh" (the loop takes the
    traversal it is given; the cell's run checks it resolves to K1)."""
    config = harness.load_json(os.path.join(
        harness.HERE, "configs", "cornell-minidragon-mesh4.json"))
    config["scene"].update(MESH["scene"])
    config["render"].update(MESH["render"], bounces=2, traversal="bvh")
    spans = trace.Spans(profiled=False)
    objs, scene, _, pos, cam_dir = harness.build_scene(config, spans, device)
    params = dict(harness.load_json(os.path.join(
        harness.HERE, "traffic", "cli_converge_mesh.json")), **traffic)
    pixels = harness.sample_pixels(32, 16, 50, SEED)
    return harness.load_module("loops", "mesh").Loop(
        scene=scene, render=config["render"], cam_pos=pos, cam_dir=cam_dir,
        params=params, pixels=pixels, spans=spans, device=device), pixels


def test_mesh_loop_gathers_each_slices_pixels():
    """A job's answer holds the sampled pixels in their order, each read
    from the slice that holds it; the config's mesh is the CPU four
    times."""
    import numpy as np

    loop, pixels = _loop(frames_per_job=2)
    assert loop.renderer.mesh.shape == {"dp": 4, "sp": 1}
    loop.setup()
    loop.window(0.0, _Run())
    frame = loop.renderer.image(loop.state).reshape(-1, 3)
    (answer,) = loop.answers()
    assert answer["key"][2] == 2
    np.testing.assert_array_equal(answer["values"], frame[pixels])


def test_mesh_loop_refuses_a_step_that_copies(monkeypatch):
    from opengl_raytracer_torch.parallel import sharding

    loop, _ = _loop(frames_per_job=1)
    loop.setup()
    plain = sharding._send
    monkeypatch.setattr(sharding, "_send", lambda cols, device: (
        plain(cols, device)[0], 1))
    with pytest.raises(RuntimeError, match="copies nothing"):
        loop.window(0.0, _Run())


class _Span:
    def __init__(self, name, start_us, end_us, step=None, args=None):
        self.name, self.step, self.args = name, step, args
        self.start_ns, self.end_ns = start_us * 1000, end_us * 1000


def _readers(monkeypatch, spans):
    from rtbench import program

    monkeypatch.setattr(program, "spans", lambda: spans)
    return (harness.load_module("metrics", "mesh.straggler_ms"),
            harness.load_module("metrics", "mesh.fold_host_ms"))


def test_mesh_readers_on_synthetic_spans(monkeypatch):
    """Inside the window (100, 200) us: step 1's cards 2, 4, 4, 6 ms lag
    the mean by 2; step 2's 3, 3, 3, 3 by 0; step 3 has one card and
    step 4 lies outside; folds of 10 and 30 us inside, one outside."""
    card = [(1, 2.0), (1, 4.0), (1, 4.0), (1, 6.0), (2, 3.0), (2, 3.0),
            (2, 3.0), (2, 3.0), (3, 9.0), (4, 1.0), (4, 50.0)]
    spans = [_Span("mesh.card", 300 if step == 4 else 110, 120, step,
                   {"card": j, "device_ms": ms})
             for j, (step, ms) in enumerate(card)]
    spans += [_Span("mesh.fold", 120, 130), _Span("mesh.fold", 150, 180),
              _Span("mesh.fold", 210, 300), _Span("step.block", 100, 190)]
    straggler, fold = _readers(monkeypatch, spans)
    run = _Run(traced=(100.0, 200.0))
    assert straggler.read(run) == pytest.approx(1.0)
    assert fold.read(run) == pytest.approx(0.02)
    assert straggler.read(_Run()) is None and fold.read(_Run()) is None


def test_mesh_readers_find_nothing(monkeypatch):
    """None where the program keeps no spans, or none of the mesh's."""
    run = _Run(traced=(100.0, 200.0))
    for spans in (None, [], [_Span("step.block", 110, 120)]):
        straggler, fold = _readers(monkeypatch, spans)
        assert straggler.read(run) is None and fold.read(run) is None
