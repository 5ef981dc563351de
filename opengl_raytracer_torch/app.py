"""Interactive / headless application (the port of
``opengl_raytracer_tpu/app.py``).

API of the reference's ``App`` (reference: main.py:16): ``App(window_size,
screen_size, bounces, rays_per_pixel, jitter_amount, lambertian,
skyIllumination, tileSize)`` authors the default scene (main.py:19-111),
then runs the frame loop: a :class:`Renderer` on ``device`` and a NumPy
framebuffer blitted to a pygame window, in place of a GL context, shaders
and SSBO uploads.  ``device`` is explicit (default ``"cuda"``): without a
card, pass ``device="cpu"`` to run the kernels' plain versions.

Behavior of the reference's loop (main.py:273-430), one :meth:`App.frame`
a loop turn, which the pygame shell (``_main_interactive``: input
polling, events, window, caption) and the benchmark's ``app_fly`` loop
(``rtbench/loops/fly.py``) both call:

* WASD/QE fly camera scaled by ``speed``; mouse look scaled by
  ``sensitivity``; gated by the M toggle (main.py:292-351);
* L toggles lambertian shading and resets accumulation (main.py:353-360);
* C prints the camera pose (main.py:362-365); R snaps rotation to 5
  degrees (main.py:367-370); ESC quits;
* any movement re-derives the camera basis and resets the progressive
  accumulation (resetFrames, main.py:252-271);
* every finished sweep is shown one frame later, while the next one
  renders (main.py:375-401): converted to 8 bits on the device, copied to
  pinned host memory on a copy stream (``utils/image.py:Display``) and
  handed to a sink, which in the shell blits it to the window;
* the caption shows fps / frame count / frame time / total render time
  (main.py:405-407);
* on exit, the accumulated frame is saved as ``render_<time>.png`` if the
  run lasted over 10 minutes (main.py:432-439).

Headless operation (no display): pass ``headless=True`` (or run without a
display server) and the loop renders ``max_frames`` progressive frames and
saves the result.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from opengl_raytracer_torch.models.scene import Scene
from opengl_raytracer_torch.ops.camera import Camera, camera_basis, make_camera
from opengl_raytracer_torch.presets import (
    DEFAULT_CAM_DIR,
    DEFAULT_CAM_POS,
    default_objects,
)
from opengl_raytracer_torch.renderer import Renderer
from opengl_raytracer_torch.utils import profiling
from opengl_raytracer_torch.utils.config import RenderConfig
from opengl_raytracer_torch.utils.image import Display, save_png
from opengl_raytracer_torch.utils.profiling import device_sync

# the fly keys (main.py:301-351): key, sign, axis of the camera basis
# (0 right, 1 forward, 2 up)
MOVE_KEYS = (("w", 1, 1), ("s", -1, 1), ("d", 1, 0), ("a", -1, 0),
             ("e", 1, 2), ("q", -1, 2))


class App:
    def __init__(
        self,
        window_size=(1920, 1080),
        screen_size=None,
        bounces: int = 7,
        rays_per_pixel: int = 1,
        jitter_amount: float = 0.001,
        lambertian: bool = True,
        skyIllumination: float = 1.0,
        tileSize: int = 1,
        scene: Scene | None = None,
        dragon: str = "stanford_minidragon",
        headless: bool | None = None,
        max_frames: int = 64,
        output: str | None = None,
        run: bool = True,
        max_leaf_tris: int | None = None,
        traversal: str | None = None,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for, but torch sees no CUDA card; "
                f"pass device='cpu' to run the kernels' plain versions")
        w, h = int(window_size[0]), int(window_size[1])
        self.screen_size = tuple(screen_size) if screen_size is not None else (w, h)
        # Ray-generation aspect comes from the DISPLAY size (reference
        # main.py:137: aspect = sw / sh), a real divergence from the render
        # aspect whenever screen_size != window_size.
        self.config = RenderConfig(
            width=w,
            height=h,
            aspect=self.screen_size[0] / self.screen_size[1],
            bounces=bounces,
            rays_per_pixel=rays_per_pixel,
            jitter_amount=jitter_amount,
            lambertian=lambertian,
            sky_brightness=skyIllumination,
            tile_size=tileSize,
            **({"max_leaf_tris": max_leaf_tris} if max_leaf_tris else {}),
            **({"traversal": traversal} if traversal else {}),
        )

        # Default scene = the reference's Cornell-box variant (main.py:19-111).
        # The BVH is built with the config's leaf bound; the renderer's
        # traversals take the scene's own (renderer.resolve_leaf_bound).
        self.scene = scene if scene is not None else Scene(
            default_objects(dragon), max_leaf_tris=self.config.max_leaf_tris,
            verbose=True,
        )
        self.renderer = Renderer(self.scene, self.config, device=self.device)

        # Camera state (main.py:151-154).
        self.camPos = np.array(DEFAULT_CAM_POS, dtype=np.float32)
        self.camDir = np.array(DEFAULT_CAM_DIR, dtype=np.float32)
        self.speed = 1.0
        self.sensitivity = 0.1
        self.canMove = False
        self.lambertian = lambertian

        self.max_frames = max_frames
        self.output = output
        self.headless = headless if headless is not None else not self._has_display()

        self.state = self.renderer.init_state()
        self.camera = self._make_camera()
        self.time_start = time.time()
        self.display: Display | None = None  # made at the first frame

        if run:
            self.main()

    @staticmethod
    def _has_display() -> bool:
        return bool(os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")
                    or os.name == "nt")

    def _make_camera(self) -> Camera:
        return make_camera(self.camPos, self.camDir)

    def get_camera_basis(self, cam_dir):
        """(right, forward, up) — reference main.py:211-237."""
        right, forward, up = camera_basis(cam_dir)
        return right, forward, up

    def get_time(self) -> str:
        """Elapsed wall-clock, reference formatting (main.py:239-250)."""
        delta = round(time.time() - self.time_start)
        h, rem = divmod(delta, 3600)
        m, s = divmod(rem, 60)
        if h > 0:
            return f"{h}h {m}m {s}s"
        if m > 0:
            return f"{m}m {s}s"
        return f"{s}s"

    def resetFrames(self) -> None:
        """Zero accumulation + counters and rebuild the camera basis
        (reference main.py:252-271)."""
        self.camera = self._make_camera()
        self.state = self.renderer.reset(self.state)
        self.time_start = time.time()
        profiling.count("app.resets")

    def image(self) -> np.ndarray:
        return self.renderer.image(self.state)

    def save(self, path: str) -> None:
        save_png(path, self.image())

    def _move(self, keys, mouse_rel) -> bool:
        """Apply the mouse and the fly keys to the camera, gated by
        ``canMove`` (main.py:292-351); True where anything moved, or a fly
        key was held."""
        delta = np.array([mouse_rel[0], -mouse_rel[1]],
                         dtype=np.float32) * self.canMove
        self.camDir += delta * self.sensitivity
        basis = self.get_camera_basis(self.camDir)
        moved = bool(delta.any())
        move = self.speed * self.canMove
        for key, sign, axis in MOVE_KEYS:
            if key in keys:
                self.camPos += sign * move * basis[axis]
                moved = True
        return moved

    def frame(self, keys, mouse_rel, present) -> None:
        """One turn of the App's loop, in the reference's order: apply
        ``keys`` (the fly keys held, a string or set of "wasdqe") and
        ``mouse_rel`` ((dx, dy) since the last frame) to the camera and
        reset on movement (span ``app.input``); one ``Renderer.step``;
        hand the previous sweep's 8-bit frame to ``present(image,
        frame_count)`` (span ``app.present``, from the wait for its copy
        to the sink's return), ``image`` an (H, W, 3) uint8 host tensor
        that stays unchanged until the next frame's ``present``; and,
        where this step ended a sweep, start that sweep's conversion and
        copy (``utils/image.py:Display``)."""
        with profiling.per_step("app.input"):
            if self._move(keys, mouse_rel):
                self.resetFrames()
        self.state = self.renderer.step(self.state, self.camera,
                                        lambertian=self.lambertian)
        if self.display is None:
            self.display = Display(self.config.height, self.config.width,
                                   self.renderer.device)
        with profiling.per_step("app.present"):
            self.display.present(present)
        if self.state.tile_x == 0 and self.state.tile_y == 0:
            self.display.start(self.state.accum, self.state.frame_count)

    def main(self) -> None:
        if self.headless:
            self._main_headless()
        else:
            self._main_interactive()

    def _main_headless(self) -> None:
        last = time.time()
        # A full sweep is num_tiles_x * num_tiles_y steps — NOT tile_size**2:
        # remainder tiles add a band per axis (e.g. 960x540 at tileSize=7 ->
        # tile_w=137 -> 8x8 bands).  Reference semantics: main.py:409-418.
        tiles = self.config.num_tiles_x * self.config.num_tiles_y
        for _ in range(self.max_frames * tiles):
            self.state = self.renderer.step(self.state, self.camera,
                                            lambertian=self.lambertian)
            if self.state.tile_x == 0 and self.state.tile_y == 0:
                device_sync(self.state.accum)  # honest per-frame timing
                now = time.time()
                print(
                    f"\rFrame {self.state.frame_count}  "
                    f"{(now - last) * 1000:.0f} ms  total {self.get_time()}",
                    end="",
                    flush=True,
                )
                last = now
        print()
        out = self.output or f"render_{self.get_time().replace(' ', '_')}.png"
        self.save(out)
        print(f"Saved {out}")

    def _main_interactive(self) -> None:
        """The pygame shell around :meth:`frame`: input polling, events,
        the window and its caption."""
        import pygame as pg

        pg.init()
        surface = pg.display.set_mode(self.screen_size)
        pg.display.set_caption("PyTorch raytracer")
        size = (self.config.width, self.config.height)
        stats = profiling.FrameStats()

        def show(image, frame_count):
            frame = pg.image.frombuffer(image.numpy(), size, "RGB")
            surface.blit(pg.transform.scale(frame, self.screen_size), (0, 0))
            pg.display.flip()
            stats.tick()
            pg.display.set_caption("PyTorch raytracer! " + stats.caption(
                frame_count, self.get_time()))

        codes = {k: getattr(pg, f"K_{k}") for k, _, _ in MOVE_KEYS}
        running = True
        while running:
            pressed = pg.key.get_pressed()
            keys = {k for k, code in codes.items() if pressed[code]}
            rel = pg.mouse.get_rel()

            for event in pg.event.get():
                if event.type == pg.QUIT:
                    running = False
                if event.type == pg.KEYDOWN:
                    if event.key == pg.K_m:
                        self.canMove = not self.canMove
                        print("\nCan move" if self.canMove else "\nCan't move")
                        pg.mouse.set_visible(not self.canMove)
                        pg.event.set_grab(self.canMove)
                    if event.key == pg.K_l:
                        # a per-step argument: no rebuild (main.py:353-360)
                        self.lambertian = not self.lambertian
                        print(f"\nSet lambertian lighting to {self.lambertian}")
                        self.resetFrames()
                    if event.key == pg.K_c:
                        print("\nCamera info:")
                        print(f"Camera position: {self.camPos}")
                        print(f"Camera rotation: {self.camDir}")
                    if event.key == pg.K_r:
                        self.camDir = np.round(self.camDir / 5) * 5
                        self.resetFrames()
                    if event.key == pg.K_ESCAPE:
                        running = False

            self.frame(keys, rel, show)

        # Exit screenshot after long runs (reference main.py:432-439).
        if time.time() - self.time_start > 10 * 60:
            self.save(f"render_{self.get_time().replace(' ', '_')}.png")
        pg.quit()
