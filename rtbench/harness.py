"""One run of one cell: build the scene, warm up, measure for ``seconds``,
check the answers against the plain reference, report.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the scene recipe, the ``RenderConfig``, the
  traversal ``"auto"`` must resolve to;
* ``traffic/<traffic>.json``: the name of a loop (``loops/<loop>.py``) and
  its parameters;
* ``cells/<workload>.json``: the cell's check: pixels compared and each
  compared number's limit;
* ``metrics/<metric>.py``: a reader of one metric (``read(run)``), for
  end-to-end and per-layer metrics alike.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "opengl_raytracer_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_module(kind: str, name: str):
    """``rtbench/<kind>/<name>.py`` as a module of its own."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"rtbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


class Run:
    """What a run measured, for the metric readers.

    ``frames``: frame end times (perf_counter s) inside the window, which
    opened at ``t_open``; ``t_start``: process start; ``spans``: the
    benchmark's host spans; with a trace, ``device_events`` and
    ``host_events`` on the profiler's clock and ``traced`` = (start us,
    end us) of the window there; after the check, ``live_share``: the
    share of rays alive as each segment starts, from the reference's
    paths."""

    def __init__(self, config: dict, spans, t_start: float):
        self.config, self.spans, self.t_start = config, spans, t_start
        render = config.get("render", {})
        self.rays_per_frame = (render.get("width", 0) * render.get("height", 0)
                               * render.get("rays_per_pixel", 0))
        self.t_open = 0.0
        self.frames: list[float] = []
        self.device_events: list = []
        self.host_events: list = []
        self.traced: tuple[float, float] | None = None
        self.live_share: list[float] | None = None

    @property
    def n_frames(self) -> int:
        return len(self.frames)

    def group_s(self) -> dict[str, float]:
        """Device seconds of each kernel group in the traced window."""
        from rtbench import trace

        lo, hi = self.traced
        out: dict[str, float] = {}
        for name, a, b in self.device_events:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                g = trace.group(name)
                out[g] = out.get(g, 0.0) + (b - a) / 1e6
        return out

    def group_ms_per_frame(self) -> dict[str, float]:
        """Device ms per frame of each kernel group in the traced window."""
        frames = max(1, self.n_frames)
        return {g: s * 1e3 / frames for g, s in self.group_s().items()}


def sample_pixels(width: int, height: int, k: int, seed: int) -> np.ndarray:
    """``k`` distinct pixels (flat, row-major from the top row) drawn
    from the seed; all of them when the frame has no more."""
    g = np.random.default_rng([seed % 2**64, 1])
    n = width * height
    return np.sort(g.choice(n, size=min(k, n), replace=False))


def build_scene(config: dict, spans, device):
    """(objects, Scene, SceneData, camera position, yaw/pitch): the
    configuration's scene, built and uploaded by the program, under the
    span ``scene``."""
    from opengl_raytracer_torch import Scene, Triangles
    from rtbench import scenes

    objs, pos, cam_dir = scenes.build(config["scene"])
    spans.begin("scene")
    scene = Scene([Triangles(o["tris"], o["normals"], color=o["color"],
                             emission_color=o["emission_color"],
                             emission=o["emission"], roughness=o["roughness"])
                   for o in objs])
    scene.fields()
    data = scene.send(device)
    if data.device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    spans.end("scene")
    return objs, scene, data, pos, cam_dir


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float | None = None,
             overrides: dict | None = None, control=None) -> dict:
    """One run: the result line's keys, and ``compared`` last.
    ``overrides`` (tests only) updates the configuration's ``scene`` and
    ``render``, the traffic's and the check's parameters.  ``control``, a
    torch dtype, adds the control's reading (``compare.control``) under
    ``control``; the benchmark's own runs never ask for it."""
    import torch

    from opengl_raytracer_torch.ops import _kernels
    from rtbench import compare, trace

    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark()
    cell = next(c for c in bench["workloads"] if c["name"] == workload)
    config = load_json(os.path.join(HERE, "configs", cell["config"] + ".json"))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     cell["traffic"] + ".json"))
    check = load_json(os.path.join(HERE, "cells", workload + ".json"))
    for key, part in (overrides or {}).items():
        {"scene": config["scene"], "render": config["render"],
         "traffic": traffic, "check": check}[key].update(part)

    spans = trace.Spans(profiled=traced)
    run = Run(config, spans, t_start)
    marks = [("imports", time.perf_counter())]
    on_card = torch.device(device).type == "cuda"
    if on_card:  # the context, before the scene's span
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    marks.append(("CUDA context", time.perf_counter()))
    objs, scene, data, pos, cam_dir = build_scene(config, spans, device)
    marks.append(("scene", time.perf_counter()))
    render = config["render"]
    pixels = sample_pixels(render["width"], render["height"],
                           check["pixels"], seed)
    loop = load_module("loops", traffic["loop"]).Loop(
        scene=scene, render=render, cam_pos=pos, cam_dir=cam_dir,
        params=traffic, pixels=pixels, spans=spans, device=device)
    marks.append(("renderer", time.perf_counter()))
    loop.setup()
    marks.append(("capture and warm-up", time.perf_counter()))
    if loop.traversal != config["traversal"]:
        raise RuntimeError(f"{workload}: traversal {config['traversal']!r} "
                           f"expected, {loop.traversal!r} resolved")
    before = dict(_kernels.launch_counts)
    prof = trace.profiler() if traced else contextlib.nullcontext()
    with prof:
        loop.window(seconds, run)
    if traced:
        run.device_events, run.host_events = trace.read(prof)
        win = [h for h in run.host_events if h[0] == "window"]
        run.traced = (win[0][1], win[0][2])
    launched = {k: n - before[k] for k, n in _kernels.launch_counts.items()}
    if on_card:  # the plain versions on the CPU count no launch
        check_launches(config["traversal"], launched, run)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    answers = loop.answers()
    loop.release()
    del scene, data
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    live = np.zeros(render["bounces"] + 1, np.int64)
    compared = compare.check(answers, objs, render, check, pixels, device,
                             live=live)
    run.live_share = [float(n) / max(1, int(live[0])) for n in live]
    correct = all(v <= lim for v, lim in compared.values())
    low = None if control is None else compare.control(
        answers, objs, render, check, pixels, device, control)
    result = {"correct": bool(correct), "attempted": run.n_frames,
              "failed": 0 if correct else run.n_frames,
              "metrics": read_metrics(bench, workload, traced, run),
              "device": device_info(device, cell["chips"], peak)}
    if traced:
        lo, hi = run.traced
        busy = trace.busy_intervals(run.device_events, lo, hi)
        result["device"]["busy_s"] = sum(b - a for a, b in busy) / 1e6
        result["device"]["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = breakdown(run, busy)
    result["check_s"] = time.perf_counter() - t_check
    report(marks, run)
    if low is not None:
        result["control"] = {k: v for k, (v, _) in low.items()}
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    return result


def report(marks: list, run: Run) -> None:
    """Set-up's parts and the mean ms of each host span in the window, on
    standard error (read by no metric)."""
    t, parts = run.t_start, []
    for name, m in [*marks, ("window opened", run.t_open)]:
        parts.append(f"{name} {m - t:.3f}")
        t = m
    print("set-up s: " + ", ".join(parts), file=sys.stderr)
    names = sorted({n for n, _, _ in run.spans.spans} - {"window"})
    print("host spans, mean ms and count: " + ", ".join(
        f"{n} {1e3 * np.mean(run.spans.durations(n)):.3f} "
        f"{len(run.spans.durations(n))}" for n in names), file=sys.stderr)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def read_metrics(bench: dict, workload: str, traced: bool, run: Run) -> dict:
    """The cell's end-to-end metrics, or with a trace its per-layer ones,
    each read by ``metrics/<name>.py``; a reader that finds nothing to
    read returns None and its metric is left out."""
    out = {}
    for m in bench["per_layer" if traced else "end_to_end"]:
        if applies(m, workload):
            value = load_module("metrics", m["name"]).read(run)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def check_launches(traversal: str, launched: dict, run: Run) -> None:
    """The window ran the traversal the configuration names and not the
    other main-path one; a traced window saw its kernel."""
    from rtbench import trace

    own, other = {"pallas2": ("subblock_traversal", "wide_traversal"),
                  "pallas": ("wide_traversal", "subblock_traversal")}.get(
                      traversal, (None, None))
    if own is not None and (launched[own] == 0 or launched[other] != 0):
        raise RuntimeError(f"{traversal}: launches in the window {own}="
                           f"{launched[own]}, {other}={launched[other]}")
    if run.traced is not None and not any(
            trace.group(n) == trace.TRAVERSALS[traversal]
            for n, _, _ in run.device_events):
        raise RuntimeError(f"the traced window saw no {traversal} kernel")


def device_info(device: str, chips: int, peak: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def breakdown(run: Run, busy) -> dict:
    """The ten kernel groups that took the most device time, and the idle
    gaps by the host span open meanwhile, in seconds."""
    from rtbench import trace

    gaps = trace.idle_gaps(busy, run.host_events, *run.traced)
    top = sorted(run.group_s().items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
