"""The port's span recorder (``opengl_raytracer_torch/utils/profiling.py``)
and the spans the program records where its work happens: nesting, the
profiler's clock, per-step spans only while tracing, the scene's four
parts, the builds, the mesh's shards, the Chrome trace export and the
CLI's ``--trace``.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_spans.py -q
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from opengl_raytracer_torch import (Rect, Renderer, RenderConfig, Scene,
                                    make_camera)
from opengl_raytracer_torch.__main__ import main
from opengl_raytracer_torch.native import loader
from opengl_raytracer_torch.ops import _kernels
from opengl_raytracer_torch.parallel.sharding import (ShardedRenderer,
                                                      make_mesh)
from opengl_raytracer_torch.utils import profiling
from opengl_raytracer_torch.utils.profiling import device_sync

PER_STEP = {"step.block", "step.body", "step.replay", "sync.wait",
            "sync.read"}
SCENE = ("scene.bvh", "scene.fields", "scene.subblock", "scene.upload")


@pytest.fixture(autouse=True)
def fresh():
    """No spans of another test, tracing off, no step."""
    profiling.clear()
    profiling.enable(False)
    profiling.set_step(None)
    yield
    profiling.enable(False)
    profiling.clear()


def _objects():
    return [Rect([4, 0.2, 4], [0, -1, 5], [0, 0, 0], color=[0.7, 0.7, 0.7],
                 roughness=1.0),
            Rect([1, 1, 1], [0, 0, 5], [0, 30, 0], color=[0.8, 0.2, 0.2],
                 emission_color=[1, 1, 1], emission=2.0)]


def _names(spans):
    return [s.name for s in spans]


def test_spans_nest_with_parent_and_step():
    profiling.set_step(7)
    with profiling.Span("outer") as outer:
        with profiling.Span("inner", {"k": 1}) as inner:
            with profiling.Span("leaf") as leaf:
                pass
    profiling.set_step(8)
    with profiling.Span("after") as after:
        pass
    got = profiling.spans()
    assert _names(got) == ["leaf", "inner", "outer", "after"]
    assert outer.parent is None and after.parent is None
    assert inner.parent is outer and leaf.parent is inner
    assert [s.step for s in got] == [7, 7, 7, 8]
    assert inner.args == {"k": 1} and outer.args is None
    assert (outer.start_ns <= inner.start_ns <= leaf.start_ns <= leaf.end_ns
            <= inner.end_ns <= outer.end_ns <= after.start_ns)
    profiling.clear()
    assert profiling.spans() == []


def test_a_span_ends_when_its_block_raises():
    with pytest.raises(RuntimeError):
        with profiling.Span("failed"):
            raise RuntimeError("x")
    with profiling.Span("next") as nxt:
        pass
    assert _names(profiling.spans()) == ["failed", "next"]
    assert nxt.parent is None


def test_clock_is_the_profilers():
    """A span around a ``record_function`` range holds the range's start
    and end as the profiler reports them."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    outer = []
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(10):
            with profiling.Span("around") as s:
                with torch.autograd.profiler.record_function(f"range{i}"):
                    torch.ones(16).sum()
            outer.append(s)
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("range")}
    assert len(ranges) == 10
    for i, s in enumerate(outer):
        e = ranges[f"range{i}"]
        assert s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() \
            <= s.end_ns


def test_tracing_follows_the_profiler_and_enable():
    assert not profiling.tracing()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.tracing()
    assert not profiling.tracing()
    profiling.enable(True)
    assert profiling.tracing()


def _render(steps):
    scene = Scene(_objects())
    r = Renderer(scene, RenderConfig(width=32, height=18, bounces=2),
                 device="cpu")
    camera = make_camera([0, 0, 0], [0, 0])
    state = r.init_state()
    for _ in range(steps):
        state = r.step(state, camera)
        device_sync(state.accum)
    return r


def test_per_step_spans_only_while_tracing():
    _render(3)
    got = profiling.spans()
    assert not PER_STEP & set(_names(got))
    assert set(SCENE) <= set(_names(got))

    profiling.clear()
    profiling.enable(True)
    _render(3)
    steps = [s for s in profiling.spans() if s.name in PER_STEP]
    assert _names(steps) == ["step.block", "step.body", "sync.wait",
                             "sync.read"] * 3
    assert [s.step for s in steps] == [1] * 4 + [2] * 4 + [3] * 4
    assert all(s.parent is None for s in steps)


def test_the_program_opens_no_profiler_range():
    """Under a profiler the per-step spans are recorded, and none of the
    program's spans reaches the profiler's events."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _render(2)
    ours = set(_names(profiling.spans()))
    assert {"step.block", "step.body", "sync.wait", "sync.read"} <= ours
    theirs = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not ours & theirs


def test_scene_records_its_four_parts(capsys):
    scene = Scene(_objects(), verbose=True)
    fields = scene.fields()
    scene.fields()  # computed once: no second span
    scene.send("cpu")
    scene.send("cpu")  # kept: no second upload
    got = {s.name: s for s in profiling.spans()}
    assert _names(profiling.spans()) == ["scene.bvh", "scene.subblock",
                                         "scene.fields", "scene.upload"]
    assert got["scene.bvh"].args["builder"] in ("native", "numpy")
    assert got["scene.subblock"].parent is got["scene.fields"]
    assert got["scene.subblock"].args == {
        "refused": False, "parts": 1, "rounds": 1,
        "largest_part_bytes": (fields["p2_node_rows"].nbytes
                               + fields["p2_tri_rows"].nbytes),
        "budget_bytes": 31_457_280, "max_parts": 4}
    assert all(got[n].parent is None for n in
               ("scene.bvh", "scene.fields", "scene.upload"))
    bvh_s = round(got["scene.bvh"].seconds, 2)
    assert f"Time taken: {bvh_s} seconds" in capsys.readouterr().out


def test_subblock_span_says_when_the_caps_refused(monkeypatch):
    from opengl_raytracer_torch.models import scene as scene_mod

    def refuse(*a, **kw):
        raise ValueError("over the caps")

    monkeypatch.setattr(scene_mod, "build_subblock_parts", refuse)
    Scene(_objects()).fields()
    sub = [s for s in profiling.spans() if s.name == "scene.subblock"]
    assert len(sub) == 1 and sub[0].args == {"refused": True}


def test_native_build_is_a_span(tmp_path, monkeypatch):
    """g++ runs under ``native.build`` (faked here: the span, not the
    compiler, is under test)."""
    lib = tmp_path / "native" / "liboglrt_native.so"
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()

    monkeypatch.setattr(loader, "_LIB_PATH", str(lib))
    monkeypatch.setattr(loader.subprocess, "run", fake_run)
    assert loader._build()
    assert calls and calls[0][0] == "g++" and lib.exists()
    assert _names(profiling.spans()) == ["native.build"]
    assert loader._build()  # newer than its sources: no build, no span
    assert len(calls) == 1 and len(profiling.spans()) == 1


def test_kernel_load_and_build_are_spans(tmp_path, monkeypatch):
    """``kernels.load`` holds ``kernels.build`` when nvcc runs (a stand-in
    nvcc that writes its ``-o`` file)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then : > \"$2\"; fi\n"
                    "  shift\ndone\n")
    nvcc.chmod(0o755)
    src = tmp_path / "k.cu"
    src.write_text("")
    lib = str(tmp_path / "lib" / "libk.so")
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_kernels, "_lib", None)

    def load():
        _kernels.compile_library(lib, [(str(src), [])])
        return "lib"

    monkeypatch.setattr(_kernels, "_load", load)
    assert _kernels.lib() == "lib"
    assert _kernels.lib() == "lib"  # loaded once
    load, build = ({s.name: s for s in profiling.spans()}[n]
                   for n in ("kernels.load", "kernels.build"))
    assert _names(profiling.spans()) == ["kernels.build", "kernels.load"]
    assert build.parent is load and build.args == {"library": "libk.so"}
    assert os.path.exists(lib)


def test_sharded_steps_record_each_shard():
    scene = Scene(_objects())
    mesh = make_mesh(devices=["cpu"] * 4, dp=2, sp=2)
    r = ShardedRenderer(scene, RenderConfig(width=32, height=18, bounces=1),
                        mesh)
    camera = make_camera([0, 0, 0], [0, 0])
    state = r.init_state()
    profiling.enable(True)
    for _ in range(2):
        state = r.step(state, camera)
    steps = [s for s in profiling.spans() if s.name in PER_STEP]
    want = [(n, k, step) for step in (1, 2) for k in range(4)
            for n in ("step.block", "step.body")]
    assert [(s.name, s.args["shard"], s.step) for s in steps] == want


def test_mesh_sync_reads_slice_zero():
    """``device_sync`` of a mesh's ``accum`` (CPU slices) returns slice
    0's head sum, not another slice's, under ``sync.wait`` and
    ``sync.read``."""
    from opengl_raytracer_torch.parallel import RowShardedAccum

    slices = [torch.full((2, 3, 3), float(j + 1)) for j in range(4)]
    slices[0][0, 0] = torch.tensor([0.5, 0.25, 2.0])
    profiling.enable(True)
    assert device_sync(RowShardedAccum(slices)) == 0.5 + 0.25 + 2.0 + 1.0
    assert _names(profiling.spans()) == ["sync.wait", "sync.read"]


def test_traced_mesh_step_records_one_fold_and_no_card_marks():
    """A traced (4, 1) mesh step on the CPU: one ``mesh.fold`` span a
    step, after the four shards' spans, and no ``mesh.card`` device span,
    since the CPU has no events."""
    scene = Scene(_objects())
    r = ShardedRenderer(scene, RenderConfig(width=32, height=16, bounces=1),
                        make_mesh(devices=["cpu"] * 4, dp=4, sp=1))
    camera = make_camera([0, 0, 0], [0, 0])
    state = r.init_state()
    profiling.enable(True)
    for _ in range(2):
        state = r.step(state, camera)
        device_sync(state.accum)
    got = [(s.name, s.step) for s in profiling.spans()
           if s.name.startswith(("mesh.", "step."))]
    want = [(n, step) for step in (1, 2)
            for n in ["step.block", "step.body"] * 4 + ["mesh.fold"]]
    assert got == want


def test_trace_exports_the_spans_of_its_block(tmp_path):
    with profiling.Span("before"):
        pass
    with profiling.trace(str(tmp_path)) as d:
        _render(2)
    with open(os.path.join(d, "trace.json")) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    ours = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
    names = [e["name"] for e in ours]
    assert "before" not in names
    assert set(SCENE) <= set(names)
    assert names.count("step.body") == 2 and names.count("sync.wait") == 2
    assert {(e["pid"], e["tid"]) for e in ours} == {(os.getpid(), 0)}
    assert all(e["ph"] == "X" for e in ours)
    by_name = {s.name: s for s in profiling.spans()}
    bvh = next(e for e in ours if e["name"] == "scene.bvh")
    assert bvh["ts"] == (by_name["scene.bvh"].start_ns - base) / 1e3
    assert bvh["args"]["builder"] == by_name["scene.bvh"].args["builder"]
    step = next(e for e in ours if e["name"] == "step.body")
    assert step["args"]["step"] == 1


def _write_obj(path):
    """An octahedron as an OBJ."""
    v = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    f = [(1, 3, 5), (3, 2, 5), (2, 4, 5), (4, 1, 5), (3, 1, 6), (2, 3, 6),
         (4, 2, 6), (1, 4, 6)]
    path.write_text("".join(f"v {x} {y} {z}\n" for x, y, z in v)
                    + "".join(f"f {a} {b} {c}\n" for a, b, c in f))
    return str(path)


def test_cli_trace_writes_the_spans(tmp_path):
    obj = _write_obj(tmp_path / "octa.obj")
    out = tmp_path / "trace"
    assert main(["--device", "cpu", "--width", "32", "--height", "18",
                 "--bounces", "1", "--frames", "2", "--obj", obj,
                 "--out", str(tmp_path / "x.png"), "--trace", str(out)]) == 0
    with open(out / "trace.json") as f:
        doc = json.load(f)
    names = [e["name"] for e in doc["traceEvents"]
             if e.get("cat") == "program_span"]
    assert names.count("step.body") == 2 and names.count("sync.wait") == 2
    assert "scene.bvh" in names
    with pytest.raises(SystemExit):
        main(["--interactive", "--device", "cpu", "--trace", str(out)])


def test_cli_trace_runs_as_a_command(tmp_path):
    """``python -m opengl_raytracer_torch --trace DIR`` from the shell."""
    obj = _write_obj(tmp_path / "octa.obj")
    out = tmp_path / "trace"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run(
        [sys.executable, "-m", "opengl_raytracer_torch", "--device", "cpu",
         "--width", "32", "--height", "18", "--bounces", "1", "--frames",
         "2", "--obj", obj, "--out", str(tmp_path / "x.png"), "--trace",
         str(out)], cwd=root, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=root))
    assert done.returncode == 0, done.stderr[-2000:]
    with open(out / "trace.json") as f:
        doc = json.load(f)
    names = [e["name"] for e in doc["traceEvents"]
             if e.get("cat") == "program_span"]
    assert names.count("step.body") == 2 and names.count("sync.wait") == 2
