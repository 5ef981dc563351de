"""The benchmark's readers of the program's spans (``rtbench/program.py``
and the eight metrics under ``rtbench/metrics/`` that read it), on
synthetic device events and spans: the scene's four parts, the idle time
split by the span the host was in, and None where a window measured a
rebuild or the program keeps no spans.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_span_readers.py -q
"""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from opengl_raytracer_torch.utils import profiling  # noqa: E402
from rtbench import harness, program, trace  # noqa: E402

SCENE = ("scene.bvh_s", "scene.subblock_s", "scene.tables_s",
         "scene.upload_s")
IDLE = {"device.idle_block_ms": "step.block",
        "device.idle_replay_ms": "step.replay",
        "device.idle_wait_ms": "sync.wait",
        "device.idle_read_ms": "sync.read"}
LO = 1_000_000_000.0  # the window's opening, us


def _span(name, a_us, b_us, parent=None, **args):
    """A program span from ``a_us`` to ``b_us`` after the window opened."""
    s = profiling.Span(name, args or None)
    s.start_ns, s.end_ns = int((LO + a_us) * 1e3), int((LO + b_us) * 1e3)
    s.parent = parent
    return s


def _run(spans, monkeypatch, frames=2, busy=((10, 30), (50, 90)),
         window=(0, 100)):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    run = harness.Run({}, trace.Spans(False), 0.0)
    run.traced = (LO + window[0], LO + window[1])
    run.device_events = [("k", LO + a, LO + b) for a, b in busy]
    run.frames = [float(i) for i in range(frames)]
    return run


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def _frame(outer=None):
    """One window's leaf spans, under ``outer`` when given: idle 40 us
    (0-10, 30-50, 90-100), of which step.block 6 + 3, step.replay 2,
    sync.wait 10, sync.read 5, none 14."""
    return [_span("step.block", 2, 8, outer),
            _span("step.replay", 8, 12, outer),
            _span("sync.wait", 35, 45, outer),
            _span("sync.read", 45, 55, outer),
            _span("step.block", 92, 95, outer)]


def test_idle_readers_split_a_known_idle_time(monkeypatch):
    run = _run(_frame(), monkeypatch)
    got = {m: _read(m, run) for m in IDLE}
    assert got == pytest.approx({"device.idle_block_ms": 9e-3 / 2,
                                 "device.idle_replay_ms": 2e-3 / 2,
                                 "device.idle_wait_ms": 10e-3 / 2,
                                 "device.idle_read_ms": 5e-3 / 2},
                                rel=1e-9)


def test_idle_readers_take_the_leaves(monkeypatch):
    """A span that holds others is not split: its leaves are."""
    outer = _span("kernels.load", 0, 100)
    run = _run([*_frame(outer), outer], monkeypatch, frames=4)
    assert _read("device.idle_block_ms", run) == pytest.approx(9e-3 / 4)
    assert _read("device.idle_wait_ms", run) == pytest.approx(10e-3 / 4)


def test_idle_readers_count_a_window_with_no_device_event(monkeypatch):
    run = _run(_frame(), monkeypatch, busy=())
    assert _read("device.idle_block_ms", run) == pytest.approx(9e-3 / 2)
    assert _read("device.idle_read_ms", run) == pytest.approx(10e-3 / 2)


def test_a_span_with_no_idle_reads_zero(monkeypatch):
    run = _run(_frame(), monkeypatch, busy=((0, 100),))
    assert all(_read(m, run) == 0.0 for m in IDLE)


@pytest.mark.parametrize("rebuild", program.REBUILDS)
def test_idle_readers_refuse_a_window_with_a_rebuild(rebuild, monkeypatch):
    run = _run([*_frame(), _span(rebuild, 60, 70)], monkeypatch)
    assert all(_read(m, run) is None for m in IDLE)


def test_idle_readers_without_their_span_or_a_trace(monkeypatch):
    run = _run([s for s in _frame() if s.name != "sync.read"], monkeypatch)
    assert _read("device.idle_read_ms", run) is None
    assert _read("device.idle_wait_ms", run) is not None
    run.traced = None
    assert all(_read(m, run) is None for m in IDLE)


def test_readers_of_a_program_without_spans(monkeypatch):
    """A program that keeps no spans (an older tree) gives None, and the
    harness leaves the metrics out."""
    run = _run(_frame(), monkeypatch)
    monkeypatch.delattr(profiling, "spans")
    assert all(_read(m, run) is None for m in (*IDLE, *SCENE))
    got = harness.read_metrics(harness.benchmark(), "minidragon-converge",
                               True, run)
    assert not set(got) & {*IDLE, *SCENE}


def _scene_spans(t0=-5_000_000.0, k=1.0):
    """A scene build that ended before the window: bvh k s, fields 3k s
    holding subblock 2k s, upload k/2 s."""
    fields = _span("scene.fields", t0 + k * 1e6, t0 + k * 4e6)
    return [_span("scene.bvh", t0, t0 + k * 1e6, builder="native"),
            _span("scene.subblock", t0 + k * 1.5e6, t0 + k * 3.5e6, fields,
                  refused=True),
            fields,
            _span("scene.upload", t0 + k * 4e6, t0 + k * 4.5e6)]


def test_scene_readers(monkeypatch):
    later = _span("scene.upload", 20, 30)  # a build inside the window
    run = _run([*_scene_spans(), *_frame(), later], monkeypatch)
    got = {m: _read(m, run) for m in SCENE}
    assert got == pytest.approx({"scene.bvh_s": 1.0,
                                 "scene.subblock_s": 2.0,
                                 "scene.tables_s": 1.0,
                                 "scene.upload_s": 0.5})
    run.traced = None
    assert all(_read(m, run) is None for m in SCENE)


def test_scene_readers_take_the_last_build(monkeypatch):
    run = _run([*_scene_spans(-20e6, k=2.0), *_scene_spans()], monkeypatch)
    assert _read("scene.tables_s", run) == pytest.approx(1.0)
    assert _read("scene.bvh_s", run) == pytest.approx(1.0)
    assert _read("scene.subblock_s", run) == pytest.approx(2.0)


@pytest.mark.parametrize("name", [*SCENE, *IDLE])
def test_metric_entry_matches_its_file(name):
    """Each metric's entry names the three CLI cells, and the App's cell
    where the App's loop holds its span (it takes no device sync), the
    four-card cell for the scene's spans (the idle readers take the union
    of the cards' kernels as busy), and its file the entry's source, unit,
    layer and moved metric."""
    entry = next(m for m in harness.benchmark()["per_layer"]
                 if m["name"] == name)
    mod = harness.load_module("metrics", name)
    fly = [] if IDLE.get(name, "").startswith("sync.") else ["minidragon-fly"]
    mesh = ["minidragon-mesh4"] if name in SCENE else []
    assert entry["workloads"] == ["minidragon-converge",
                                  "asiandragon-converge", "buddha-converge",
                                  *fly, *mesh]
    assert (mod.SOURCE, mod.UNIT, mod.LAYER, mod.MOVES) == (
        entry["source"], entry["unit"], entry["layer"], entry["moves"])
    assert entry["layer"] == ("Scene authoring" if name in SCENE
                              else "Device")


# K1's part chain (the two k1chain.* metrics, and k1.device_ms over the
# whole chain): device events of kernels named as the card's trace names
# them
CHAIN = ("k1chain.later_parts_ms", "k1chain.g4_ms")
PROLOGUE = "void (anonymous namespace)::wide_prologue_kernel(bool const*)"
K1 = "void (anonymous namespace)::traverse_kernel(float const*)"
G4 = "void (anonymous namespace)::part_epilogue_kernel(float const*)"
K2 = "void (anonymous namespace)::shade_kernel(float const*)"


def _chain_run(monkeypatch, parts=16, segments=3, frames=2, drop=None,
               **args):
    """A window of ``segments`` bounce segments over ``parts`` parts: each
    a 1-us prologue, then per part a K1 launch of (part + 1) us and a 2-us
    G4, then a 5-us K2; ``drop`` = (segment, part) leaves that K1 launch
    out.  The scene's span, before the window, has ``args`` (``parts``
    unless given)."""
    events, t = [], 10.0
    for s in range(segments):
        events.append((PROLOGUE, LO + t, LO + t + 1))
        t += 1
        for p in range(parts):
            if (s, p) != drop:
                events.append((K1, LO + t, LO + t + p + 1))
            t += p + 1
            events.append((G4, LO + t, LO + t + 2))
            t += 2
        events.append((K2, LO + t, LO + t + 5))
        t += 5
    args = {"refused": False, "parts": parts, **args}
    scene = _span("scene.subblock", -2e6, -1e6, **args)
    run = _run([scene], monkeypatch, frames=frames, window=(0, t + 10))
    run.device_events = events
    return run


def test_chain_readers_split_sixteen_parts(monkeypatch):
    run = _chain_run(monkeypatch)
    k1 = 3 * sum(range(1, 17))  # us, three segments
    got = {m: _read(m, run) for m in (*CHAIN, "k1.device_ms")}
    assert got == pytest.approx({
        "k1.device_ms": (k1 + 3 * 16 * 2 + 3) / 1e3 / 2,
        "k1chain.later_parts_ms": (k1 - 3) / 1e3 / 2,
        "k1chain.g4_ms": 3 * 16 * 2 / 1e3 / 2}, rel=1e-9)
    got = harness.read_metrics(harness.benchmark(), "buddha-converge", True,
                               run)
    assert {*CHAIN, "k1.device_ms"} <= set(got)
    for cell in ("minidragon-converge", "asiandragon-converge"):
        assert not set(CHAIN) & set(harness.read_metrics(
            harness.benchmark(), cell, True, run))


@pytest.mark.parametrize("cut", [(40.0, 300.0), (11.5, 430.5),
                                 (25.0, 190.5), (0.0, 157.0)])
def test_chain_reader_takes_segments_cut_by_the_window(monkeypatch, cut):
    """The trace's device clock may lie off the host's by more than the
    time from the window's opening to its first prologue: the window's
    edges then cut its first and last segments.  The launches before the
    first prologue are the last parts of theirs, and those of the last
    segment the first parts; launches that start outside the window are
    left out, as ``k1.device_ms`` leaves them out."""
    run = _chain_run(monkeypatch)
    lo, hi = run.traced = (LO + cut[0], LO + cut[1])
    k1 = [(a, b) for n, a, b in run.device_events if n == K1]
    want = sum(min(b, hi) - a for i, (a, b) in enumerate(k1)
               if lo <= a < hi and i % 16 != 0)
    assert _read("k1chain.later_parts_ms", run) == pytest.approx(
        want / 1e3 / 2, rel=1e-12)


def test_chain_reader_refuses_a_segment_missing_a_launch(monkeypatch):
    run = _chain_run(monkeypatch, drop=(1, 7))
    assert _read("k1chain.later_parts_ms", run) is None
    assert _read("k1.device_ms", run) is not None
    assert _read("k1chain.g4_ms", run) is not None


def test_chain_reader_needs_the_parts_arg(monkeypatch):
    """A program that does not report its parts (an older tree) gives no
    split; the device trace alone still gives K1's and G4's time."""
    run = _chain_run(monkeypatch)
    monkeypatch.setattr(profiling, "spans", lambda: [
        _span("scene.subblock", -2e6, -1e6, refused=False)])
    assert _read("k1chain.later_parts_ms", run) is None
    assert _read("k1chain.g4_ms", run) == pytest.approx(0.096 / 2)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert _read("k1chain.later_parts_ms", run) is None
    monkeypatch.delattr(profiling, "spans")
    assert _read("k1chain.later_parts_ms", run) is None


def test_chain_reader_of_one_part(monkeypatch):
    run = _chain_run(monkeypatch, parts=1)
    assert _read("k1chain.later_parts_ms", run) is None
    assert _read("k1.device_ms", run) == pytest.approx(
        (3 * 1 + 3 * 2 + 3) / 1e3 / 2)
    assert _read("k1chain.g4_ms", run) == pytest.approx(3 * 2 / 1e3 / 2)


def test_chain_readers_without_a_trace(monkeypatch):
    run = _chain_run(monkeypatch)
    run.traced = None
    assert all(_read(m, run) is None for m in CHAIN)


@pytest.mark.parametrize("name", CHAIN)
def test_chain_entry_matches_its_file(name):
    entry = next(m for m in harness.benchmark()["per_layer"]
                 if m["name"] == name)
    mod = harness.load_module("metrics", name)
    assert entry["workloads"] == ["buddha-converge"]
    assert (mod.SOURCE, mod.UNIT, mod.LAYER, mod.MOVES) == (
        entry["source"], entry["unit"], entry["layer"], entry["moves"])
    assert (entry["layer"], entry["better"]) == ("K1 part chain", "lower")
