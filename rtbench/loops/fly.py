"""The App's interactive loop (``opengl_raytracer_torch/app.py:App.frame``;
the reference's ``main.py:273-439``): a user flies the camera for a few
frames, then holds still and watches the image converge, and every frame
is shown.

The loop builds an ``App`` over the cell's scene and render settings and
calls ``App.frame`` once a frame, closed loop, with no frame cap, as the
pygame shell does; the window's blit and flip are not run (the card's
machine has no display).  The input is cycles of ``frames_per_cycle``
frames: ``moving_frames`` frames each with one fly key held (the App's
``speed``) and the mouse moved ``mouse_x`` units in x (``canMove`` on;
2 degrees of yaw at the App's ``sensitivity`` of 0.1), then still frames.
Cycles alternate W with the mouse moving right and S with it moving left.
A frame ends (``run.frames``) at its present, in the sink, which keeps the
shown buffer and, for a compared frame, its bytes at the sampled pixels.

Compared frames, gathered at the sampled pixels on the card right after
the frame's step: each cycle's last frame (its still pose,
``frames_per_cycle - moving_frames + 1`` frames) and, in the first cycle
of each direction, the moving frames ``compared_moving`` names (one frame
each).  The window runs past its end until one compared frame was shown.
After the window the loop raises where the bytes the sink got for a
compared frame differ from ``to_uint8`` of its gathered values, or where
the program's counters disagree with the frames run: one present a frame,
one reset a moving frame, one conversion launch a frame on the card, no
graph captured.  The answers, with compare.py's key of pose and frames,
are the compared moving frames and the still poses of the first and of
the last complete cycle of each direction: each pose costs the reference
one render of its own (about 2-3 s on the card), and the flight drifts, so
every cycle's still pose is a new one.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class Loop:
    def __init__(self, *, scene, render, cam_pos, cam_dir, params,
                 pixels, spans, device):
        from opengl_raytracer_torch.app import App

        if not hasattr(App, "frame"):
            raise RuntimeError("the app_fly traffic drives App.frame, which "
                               "this program's App does not have")
        if render["tile_size"] != 1:
            raise ValueError("app_fly takes a frame to be one sweep: "
                             "tile_size must be 1")
        self.params, self.spans = params, spans
        self.start = (np.array(cam_pos, np.float32),
                      np.array(cam_dir, np.float32))
        self.app = App(window_size=(render["width"], render["height"]),
                       bounces=render["bounces"],
                       rays_per_pixel=render["rays_per_pixel"],
                       jitter_amount=render["jitter_amount"],
                       lambertian=render["lambertian"],
                       skyIllumination=render["sky_brightness"],
                       tileSize=render["tile_size"], scene=scene,
                       traversal=render["traversal"], headless=True,
                       run=False, device=device)
        self.traversal = self.app.renderer.traversal
        self.index = torch.as_tensor(pixels, device=self.app.renderer.device)
        self.host_index = torch.as_tensor(pixels)
        self.finished: list = []  # (key, values on the device, cycle)
        self.shown_bytes: dict = {}  # answer -> bytes the sink got
        self.shown = None  # the buffer the sink holds
        self._expect = None  # the answer the next present shows
        self._run = None

    def _input(self, j: int):
        """(keys, mouse_rel) of window frame ``j``."""
        p = self.params
        cycle, k = divmod(j, p["frames_per_cycle"])
        if k >= p["moving_frames"]:
            return "", (0, 0)
        sign = 1 if cycle % 2 == 0 else -1
        return ("w" if sign > 0 else "s"), (sign * p["mouse_x"], 0)

    def _compared(self, j: int) -> int | None:
        """The frames ``accum`` holds after window frame ``j`` where it is
        an answer, else None."""
        p = self.params
        F, M = p["frames_per_cycle"], p["moving_frames"]
        cycle, k = divmod(j, F)
        if k < M and cycle < 2 and k in p["compared_moving"]:
            return 1
        return F - M + 1 if k == F - 1 else None

    def _sink(self, image, frame_count) -> None:
        self.shown = image
        if self._expect is not None:
            i, frames = self._expect
            if frame_count != frames:
                raise RuntimeError(f"presented frame {frame_count}, "
                                   f"expected {frames}")
            self.shown_bytes[i] = image.view(-1, 3)[self.host_index].numpy()
            self._expect = None
        self._run.frames.append(time.perf_counter())

    def setup(self) -> None:
        """Capture the step's graph and warm up a moving and a still frame
        of each direction, then put the camera back at the cell's pose."""
        from opengl_raytracer_torch.utils.profiling import device_sync

        a, x = self.app, self.params["mouse_x"]
        a.camPos, a.camDir = (v.copy() for v in self.start)
        a.canMove = True
        a.resetFrames()
        for keys, rel in (("w", (x, 0)), ("", (0, 0)), ("s", (-x, 0)),
                          ("", (0, 0))):
            a.frame(keys, rel, lambda image, frame_count: None)
        a.camPos, a.camDir = (v.copy() for v in self.start)
        a.resetFrames()
        device_sync(a.state.accum)

    def frame(self, j: int) -> None:
        """Window frame ``j``: its input, ``App.frame``, and where it is
        compared, its ``accum`` at the sampled pixels."""
        a, sp = self.app, self.spans
        keys, rel = self._input(j)
        sp.begin("frame")
        a.frame(keys, rel, self._sink)
        sp.end("frame")
        frames = self._compared(j)
        if frames is not None:
            sp.begin("gather")
            state = a.state
            if state.frame_count != frames:
                raise RuntimeError(f"frame {j} holds {state.frame_count} "
                                   f"frames, expected {frames}")
            key = (tuple(float(v) for v in a.camPos),
                   tuple(float(v) for v in a.camDir), frames)
            self.finished.append((key, state.accum.view(-1, 3)[self.index],
                                  j // self.params["frames_per_cycle"]))
            self._expect = (len(self.finished) - 1, frames)
            sp.end("gather")

    def window(self, seconds: float, run) -> None:
        from opengl_raytracer_torch.ops import _kernels
        from opengl_raytracer_torch.utils import profiling

        self._run = run
        counts = profiling.counts()
        launches = _kernels.launch_counts["to_uint8"]
        self.spans.begin("window")
        run.t_open = t = time.perf_counter()
        deadline = t + seconds
        j = moving = 0
        while t < deadline or not self.shown_bytes:
            moving += bool(self._input(j)[0])
            self.frame(j)
            j += 1
            t = time.perf_counter()
        self.spans.end("window")
        added = {k: n - counts.get(k, 0)
                 for k, n in profiling.counts().items()}
        want = {"app.presented": j, "app.resets": moving,
                "step.captures": 0}
        got = {k: added.get(k, 0) for k in want}
        if self.app.renderer.device.type == "cuda":
            want["to_uint8"] = j
            got["to_uint8"] = _kernels.launch_counts["to_uint8"] - launches
        if got != want or len(run.frames) != j:
            raise RuntimeError(f"the window's {j} frames ({len(run.frames)} "
                               f"presented) counted {got}, expected {want}")

    def answers(self) -> list:
        from opengl_raytracer_torch.utils.image import to_uint8

        still: dict = {}  # direction -> the still answers' indices
        keep = set()
        for i, (key, values, cycle) in enumerate(self.finished):
            if i in self.shown_bytes:
                if not np.array_equal(self.shown_bytes[i],
                                      to_uint8(values.cpu().numpy())):
                    raise RuntimeError(f"answer {i} {key}: the bytes shown "
                                       f"differ from to_uint8 of the frame")
            elif i != len(self.finished) - 1:
                raise RuntimeError(f"answer {i} {key} was never shown")
            if key[2] == 1:
                keep.add(i)
            else:
                still.setdefault(cycle % 2, []).append(i)
        for ids in still.values():
            keep.update((ids[0], ids[-1]))
        return [dict(key=self.finished[i][0],
                     values=self.finished[i][1].double().cpu().numpy())
                for i in sorted(keep)]

    def release(self) -> None:
        self.app = self.index = self.shown = None
