"""The headless render loop of the CLI and ``App._main_headless``
(``opengl_raytracer_torch/app.py:174-186``): a fixed camera, then
``Renderer.step`` back to back with a device sync at each sweep's end.

A job is one image of ``frames_per_job`` frames (the CLI's ``--frames``),
started from a fresh ``accum`` (``Renderer.reset``); jobs follow each
other until the window closes.  Every job renders frames 0 ..
``frames_per_job - 1`` at the run's camera, so every finished job is an
answer held to one reference.  At a job's end the benchmark gathers the
sampled pixels of its ``accum`` on the card (one small launch a job).
"""

from __future__ import annotations

import time

import torch


class Loop:
    def __init__(self, *, scene, render, cam_pos, cam_dir, params,
                 pixels, spans, device):
        from opengl_raytracer_torch import RenderConfig, Renderer, make_camera

        self.params, self.spans = params, spans
        self.cam_pos, self.cam_dir = cam_pos, cam_dir
        self.renderer = Renderer(scene, RenderConfig(**render), device=device)
        self.traversal = self.renderer.traversal
        self.camera = make_camera(cam_pos, cam_dir)
        self.index = torch.as_tensor(pixels, device=self.renderer.device)
        self.finished: list = []
        self.state = None

    def setup(self) -> None:
        """Capture the step's graph and run two frames of it."""
        from opengl_raytracer_torch.utils.profiling import device_sync

        state = self.renderer.init_state()
        for _ in range(2):
            state = self.renderer.step(state, self.camera)
            device_sync(state.accum)
        self.state = state

    def window(self, seconds: float, run) -> None:
        from opengl_raytracer_torch.utils.profiling import device_sync

        r, sp, F = self.renderer, self.spans, self.params["frames_per_job"]
        sp.begin("window")
        run.t_open = t = time.perf_counter()
        deadline = t + seconds
        state = self.state
        while t < deadline:
            sp.begin("reset")
            state = r.reset(state)
            sp.end("reset")
            for _ in range(F):
                sp.begin("step")
                state = r.step(state, self.camera)
                sp.end("step")
                sp.begin("sync")
                device_sync(state.accum)
                sp.end("sync")
                t = time.perf_counter()
                run.frames.append(t)
                if t >= deadline:
                    break
            if state.frame_count == F:
                sp.begin("gather")
                self.finished.append(state.accum.view(-1, 3)[self.index])
                sp.end("gather")
        sp.end("window")
        self.state = state

    def answers(self) -> list:
        key = (tuple(self.cam_pos), tuple(self.cam_dir),
               self.params["frames_per_job"])
        return [dict(key=key, values=v.double().cpu().numpy())
                for v in self.finished]

    def release(self) -> None:
        self.renderer = self.state = self.index = None
