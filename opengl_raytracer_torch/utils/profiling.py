"""Profiling & timing utilities (the port of
``opengl_raytracer_tpu/utils/profiling.py``).

The reference's only instrumentation is wall-clock prints (BVH build time
scene.py:139-143, per-frame fps in the caption main.py:405-407).  Here: a
timer that fences on the device before it reads the clock (torch returns
before a CUDA card finishes), and a wrapper around ``torch.profiler`` that
writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


def device_sync(x: torch.Tensor) -> float:
    """Wait for everything queued on ``x``'s card (when it is a CUDA
    tensor), then read back a scalar: the sum of ``x``'s first four
    values."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(x.reshape(-1)[:4].sum())


@contextlib.contextmanager
def timer(label: str = "", sync_on=None, results: dict | None = None):
    """Wall-clock a block; if sync_on is given, fences on it before reading
    the clock."""
    t0 = time.time()
    yield
    if sync_on is not None:
        device_sync(sync_on)
    dt = time.time() - t0
    if results is not None:
        results[label] = dt
    if label:
        print(f"[timer] {label}: {dt * 1000:.1f} ms")


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` over the block (CPU activity, plus CUDA activity
    when a card is present); writes ``trace.json``, a Chrome trace, into
    ``log_dir`` (default ``oglrt-trace`` in the temporary directory) and
    yields the directory."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "oglrt-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class FrameStats:
    """Running fps / frame-time tracker (the reference's caption metrics,
    main.py:405-428, as a reusable object)."""

    def __init__(self):
        self.last = time.time()
        self.delta = 0.0
        self.fps = 0.0
        self.frames = 0

    def tick(self) -> None:
        now = time.time()
        self.delta = now - self.last
        self.fps = 1.0 / self.delta if self.delta > 0 else 0.0
        self.last = now
        self.frames += 1

    def caption(self, frame_count: int, total: str) -> str:
        return (
            f"Fps: {round(self.fps)} Frame: {frame_count} "
            f"Frame render time: {round(self.delta * 1000)}ms "
            f"Total render time: {total}"
        )
