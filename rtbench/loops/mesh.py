"""The CLI's headless loop on a mesh (``opengl_raytracer_torch/__main__.py:
_main_sharded``, ``--devices N --dp D --sp S``): a fixed camera, then
``ShardedRenderer.step`` back to back with a sync of every card
(``device_sync`` of the mesh's ``accum``) at each sweep's end.

The configuration's ``render`` names the mesh under ``mesh`` (``dp``,
``sp``), which is taken out before ``RenderConfig(**render)``.  On CUDA
the mesh is the first dp * sp cards, as the CLI builds it (``make_mesh``'s
default devices); on the CPU it is the CPU dp * sp times, as the CLI's
``--device cpu``.  A test may name the devices under the traffic's
``devices`` (one card repeated, say); the benchmark's traffic names none.

A job is one image of ``frames_per_job`` frames (the CLI's ``--frames``),
started from a fresh ``accum`` (``ShardedRenderer.reset``); jobs follow
each other until the window closes, and past its end until one job has
finished.  A sweep converges sp frames and ends a window frame
(``run.frames``).  At a job's end the benchmark gathers the sampled
pixels from the slices that hold them, each on its own card.  The spans
are ``cli_converge``'s (``step``, ``sync``, ``reset``, ``gather``).
The window raises where the program's counter ``mesh.bytes_moved`` is
missing or moved: with whole-frame bands (``tile_size`` 1) and sp 1 each
card renders and folds its own slice and copies nothing to another.
"""

from __future__ import annotations

import sys
import time

import torch


def _syncs_a_mesh() -> bool:
    """Does the program's ``device_sync`` wait for a mesh's ``accum``?"""
    from opengl_raytracer_torch.parallel import RowShardedAccum
    from opengl_raytracer_torch.utils.profiling import device_sync

    try:
        device_sync(RowShardedAccum([torch.zeros((1, 1, 3))]))
    except AttributeError:
        return False
    return True


class Loop:
    def __init__(self, *, scene, render, cam_pos, cam_dir, params,
                 pixels, spans, device):
        from opengl_raytracer_torch import RenderConfig, make_camera
        from opengl_raytracer_torch.parallel import ShardedRenderer, make_mesh

        if not _syncs_a_mesh():
            raise RuntimeError("the cli_converge_mesh traffic waits for "
                               "every card through device_sync, which in "
                               "this program takes no RowShardedAccum")
        render = dict(render)
        shape = render.pop("mesh")
        dp, sp = shape["dp"], shape["sp"]
        devices = params.get("devices")
        if devices is None and torch.device(device).type != "cuda":
            devices = [torch.device(device)] * (dp * sp)
        mesh = make_mesh(n_devices=dp * sp, dp=dp, sp=sp, devices=devices)
        self.params, self.spans = params, spans
        self.cam_pos, self.cam_dir = cam_pos, cam_dir
        self.renderer = ShardedRenderer(scene, RenderConfig(**render), mesh)
        self.traversal = self.renderer.traversal
        self.camera = make_camera(cam_pos, cam_dir)
        cfg = self.renderer.config
        if params["frames_per_job"] % sp:
            raise ValueError(f"frames_per_job must be a multiple of sp={sp}")
        self.tiles = cfg.num_tiles_x * cfg.num_tiles_y
        # each sampled pixel's index in the slice that holds it, on its card
        n = cfg.height // dp * cfg.width
        flat = torch.as_tensor(pixels)
        self.index = [(flat[(flat >= j * n) & (flat < (j + 1) * n)] - j * n)
                      .to(owner) for j, owner in
                      enumerate(self.renderer.owners)]
        self.finished: list = []
        self.state = None

    def sweep(self, state):
        """The steps of one sweep, each under the span ``step``, then the
        sync of every card under ``sync``."""
        from opengl_raytracer_torch.utils.profiling import device_sync

        r, sp = self.renderer, self.spans
        for _ in range(self.tiles):
            sp.begin("step")
            state = r.step(state, self.camera)
            sp.end("step")
        sp.begin("sync")
        device_sync(state.accum)
        sp.end("sync")
        return state

    def setup(self) -> None:
        """Capture each shard's graph and run two sweeps."""
        state = self.renderer.init_state()
        for _ in range(2):
            state = self.sweep(state)
        self.state = state

    def window(self, seconds: float, run) -> None:
        from opengl_raytracer_torch.utils import profiling

        r, sp, F = self.renderer, self.spans, self.params["frames_per_job"]
        before = profiling.counts().get("mesh.bytes_moved", 0)
        sp.begin("window")
        run.t_open = t = time.perf_counter()
        deadline = t + seconds
        state = self.state
        while t < deadline or not self.finished:
            sp.begin("reset")
            state = r.reset(state)
            sp.end("reset")
            for _ in range(F // r.frames_per_step):
                state = self.sweep(state)
                t = time.perf_counter()
                run.frames.append(t)
                if t >= deadline and self.finished:
                    break
            if state.frame_count == F:
                sp.begin("gather")
                self.finished.append([
                    s.view(-1, 3)[i]
                    for s, i in zip(state.accum.slices, self.index)])
                sp.end("gather")
        sp.end("window")
        self.state = state
        moved = profiling.counts().get("mesh.bytes_moved")
        if moved is None or moved != before:
            raise RuntimeError(f"mesh.bytes_moved {before} before the "
                               f"window, {moved} after: each card folds its "
                               f"own slice and copies nothing")

    def answers(self) -> list:
        key = (tuple(self.cam_pos), tuple(self.cam_dir),
               self.params["frames_per_job"])
        return [dict(key=key, values=torch.cat(
                    [v.double().cpu() for v in parts]).numpy())
                for parts in self.finished]

    def release(self) -> None:
        cards = dict.fromkeys(d for d in self.renderer.mesh.devices.flat
                              if d.type == "cuda")
        if cards:  # the harness's result holds card 0's alone
            print("peak device memory by card, B: " + ", ".join(
                f"{d} {torch.cuda.max_memory_allocated(d)}" for d in cards),
                file=sys.stderr)
        self.renderer = self.state = self.index = None
