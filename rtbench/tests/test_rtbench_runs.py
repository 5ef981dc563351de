"""Runs of the harness on the CPU at a tiny size (the program's plain
versions, 32x18 pixels, a 404-triangle scene): what a run imports, and
the comparison that decides ``correct``: the program passes, the control (the reference in
bfloat16) fails, and so does the program with its timed path broken
underneath in each way a render can break.  One test runs on a card.

    python -m pytest rtbench/tests -q
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from rtbench import harness  # noqa: E402

TINY = {"scene": {"dragon_cells": [8, 16], "ball_cells": [4, 8]},
        "render": {"width": 32, "height": 18},
        "check": {"pixels": 200}}
CONVERGE = dict(TINY, traffic={"frames_per_job": 2})
SEED = 2**33 + 12345


def _run(workload, overrides, seconds=2.5, **kw):
    return harness.run_cell(workload, SEED, seconds, False, device="cpu",
                            overrides=overrides, **kw)


def _loaded(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole run, and every module of the harness, leave
    neither JAX nor the JAX package in ``sys.modules`` (top-level names
    compared whole: the port's name begins with the JAX package's)."""
    code = (
        "import glob, os, runpy\n"
        "runpy.run_path('rtbench/run.py', run_name='rtbench_run')\n"
        "from rtbench import harness, compare\n"
        "for p in glob.glob('rtbench/*/*.py'):\n"
        "    kind, name = p.split(os.sep)[-2], os.path.basename(p)[:-3]\n"
        "    if kind not in ('tests', 'reference'):\n"
        "        harness.load_module(kind, name)\n"
        f"harness.run_cell('minidragon-converge', 7, 2.0, True, device='cpu',"
        f" overrides={CONVERGE!r})\n")
    loaded = _loaded(code)
    assert "opengl_raytracer_torch" in loaded and "torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    code = ("from rtbench.reference import pathtrace\n"
            "from rtbench import compare, scenes\n"
            "import numpy as np, torch\n"
            "objs, pos, d = scenes.build({'dragon_cells': [4, 8], "
            "'ball_cells': [4, 8]})\n"
            "compare.references([(pos, d, 2)], objs, {'width': 8, "
            "'height': 6, 'bounces': 2, 'jitter_amount': 0.001, "
            "'lambertian': True, 'sky_brightness': 1.0}, np.arange(10), "
            "'cpu')\n")
    loaded = _loaded(code)
    assert "torch" in loaded
    assert not loaded & {"opengl_raytracer_torch", *harness.FORBIDDEN}


def test_program_passes_and_control_fails():
    res = _run("minidragon-converge", CONVERGE, control=torch.bfloat16)
    limit = res["compared"]["bad_pixels_pct"]["limit"]
    assert res["correct"], res["compared"]
    assert res["control"]["bad_pixels_pct"] > limit, res


def _unchanged(monkeypatch):
    """A step that leaves ``accum`` as it was."""
    from opengl_raytracer_torch import renderer
    monkeypatch.setattr(renderer.Renderer, "_body", lambda self, accum: None)


def _half(monkeypatch):
    """Half of the batch left out: the second half of each step's rays is
    not traced and takes the colours of the first half."""
    from opengl_raytracer_torch import renderer
    flat = renderer.render_flat

    def half(*a, **kw):
        cols = flat(*a, **kw)
        n = cols[0].shape[0] // 2
        return tuple(torch.cat([c[:n], c[:c.shape[0] - n]]) for c in cols)
    monkeypatch.setattr(renderer, "render_flat", half)


def _altered(monkeypatch):
    """Each answer altered where it is produced: the step's colours 2%
    brighter."""
    from opengl_raytracer_torch import renderer
    flat = renderer.render_flat
    monkeypatch.setattr(renderer, "render_flat",
                        lambda *a, **kw: tuple(c * 1.02
                                               for c in flat(*a, **kw)))


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _run("minidragon-converge", CONVERGE)
    assert not res["correct"], res["compared"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")


@pytest.mark.cuda
def test_a_run_on_the_card(card):
    """One short run of the headline cell through the command, on the
    card: exit 0, ``correct`` true, the contract's keys."""
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "minidragon-converge",
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
