"""Progressive tile renderer.

The port of ``opengl_raytracer_tpu/renderer.py``:

* the per-pixel front (seed, three warm-ups, angle-linear ray, two jitter
  draws) follows fragment.glsl ``main()`` (fragment.glsl:376-407); it is
  ``ops/front.py:ray_front``, one kernel launch a chunk on the card;
* progressive accumulation is the running mean ``(prev * frameNumber +
  curr) / (frameNumber + F)`` (fragment.glsl:409-414);
* one ``(W/tiles) x (H/tiles)`` band renders per step, and the frame
  counter advances after a full sweep (main.py:409-418).  Remainder tiles
  clamp the band into the frame and mask the merge (G6, ``ops/fold.py``).

Every value of a step that changes from step to step (frame number, tile
window, camera, sky, jitter, ``lambertian``, ``accum``'s address) is
written into the renderer's step block (``ops/step_block.py``) before the
step, and the step's kernels read it there.  Each step writes the block of
the step it predicts next behind its own body, so a step that follows as
predicted enqueues nothing before its replay.  So on a card the step's body
is captured once as a CUDA graph and replayed every step
(``step_graph.py``), the counterpart of the JAX package's
``jax.jit(_tile_step)``.

``accum`` is updated IN PLACE by every step, the analogue of the JAX
package's buffer donation (its ``jax.jit(..., donate_argnums=(2,))``): a
caller that keeps an image across steps copies it first.  ``accum`` is
stored top-row-first; ray generation uses GL bottom-up pixel coordinates.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opengl_raytracer_torch import step_graph
from opengl_raytracer_torch.models.scene import Scene, SceneData
from opengl_raytracer_torch.ops import pallas_traversal as wide
from opengl_raytracer_torch.ops import step_block
from opengl_raytracer_torch.ops import subblock_traversal as sbt
from opengl_raytracer_torch.ops.camera import Camera, make_camera
from opengl_raytracer_torch.ops.fold import fold_band
from opengl_raytracer_torch.ops.front import BLOCK_H, BLOCK_W, ray_front
from opengl_raytracer_torch.ops.integrator import trace
from opengl_raytracer_torch.ops.intersect import raycast_brute
from opengl_raytracer_torch.ops.permute import SeedRecon
from opengl_raytracer_torch.ops.traversal import (PACKET, raycast_bvh,
                                                  raycast_packet)
from opengl_raytracer_torch.presets import DEFAULT_CAM_DIR, DEFAULT_CAM_POS
from opengl_raytracer_torch.utils import profiling
from opengl_raytracer_torch.utils.config import RenderConfig

_DEFAULT_CHUNK = 2 * 1024 * 1024
# on the CPU, the plain versions of brute force ((R, 2048) intermediates)
# and of the BVH walk (per-ray loop state) bound their chunks, as in the
# JAX package (renderer.py:239-241); their kernels keep a ray's state in
# registers and take the default chunk
_SMALL_CHUNK = 128 * 1024
_BRUTE_MAX_TRIS = 128  # "auto" picks brute force up to this many triangles
_MAX_LEAF = 1024  # larger leaves (build_bvh=False) only by brute force
_REORDER = ("packet", "pallas", "pallas2")


def effective_max_leaf(scene: SceneData) -> int:
    """The leaf-loop bound of this scene's BVH, its largest leaf
    (``opengl_raytracer_tpu/renderer.py:53-76``; ``SceneData.max_leaf``):
    a smaller bound would skip triangles, a larger one would read past the
    slack of the wide kernel's octet table."""
    return scene.max_leaf


def resolve_leaf_bound(scene: SceneData, config: RenderConfig) -> RenderConfig:
    """``config`` with ``max_leaf_tris`` set to the leaf bound the
    traversals of ``scene`` take: the scene's own,
    :func:`effective_max_leaf`, whatever bound the config or the build
    asked for (the JAX package's ``resolve_leaf_bound``,
    ``opengl_raytracer_tpu/renderer.py:69-76``).  The renderers keep the
    config it returns and hand its bound to ``make_raycast_fn``."""
    eff = effective_max_leaf(scene)
    if eff != config.max_leaf_tris:
        config = dataclasses.replace(config, max_leaf_tris=eff)
    return config


def make_raycast_fn(scene: SceneData, traversal: str, max_leaf_tris: int):
    """Bind ``raycast(o3, d3, active) -> Nearest`` for the chosen
    traversal: "brute" (dense sweep, G8), "bvh" (per-ray stackless walk,
    G7), "packet" (the 128-ray packet walk, G9), "pallas" (the wide-BVH
    kernel, K3) or "pallas2" (the sub-block kernel, K1).
    ``max_leaf_tris`` must cover the scene's largest leaf
    (:func:`effective_max_leaf`)."""
    if traversal == "brute":
        return lambda o3, d3, active=None: raycast_brute(scene, o3, d3, active)
    if traversal in ("bvh", "packet"):
        walk = raycast_bvh if traversal == "bvh" else raycast_packet
        return lambda o3, d3, active=None: walk(
            scene, o3, d3, active, max_leaf_tris=max_leaf_tris)
    if traversal == "pallas":
        return lambda o3, d3, active=None: wide.raycast_pallas(
            scene, o3, d3, active)
    if traversal == "pallas2":
        return lambda o3, d3, active=None: sbt.raycast_subblock(scene, o3, d3,
                                                                active)
    raise ValueError(f"unknown traversal {traversal!r}")


def resolve_traversal(scene: SceneData, traversal: str) -> str:
    """The traversal a ``RenderConfig.traversal`` name runs on ``scene``.

    "auto" follows the JAX package (``renderer.py:415-464``): brute force
    for scenes of at most 128 (padded) triangles, else the sub-block
    kernel "pallas2" when the scene has its tables, else the wide-BVH
    kernel "pallas".  The JAX package's 13 MB bound between "pallas" and
    "packet" is the TPU's VMEM budget for the wide kernel's tables, and its
    "auto" runs "packet" off a TPU; neither applies on the card, where
    "auto" never picks "packet".  Last, a scene with a leaf over 1024
    triangles (``Scene(build_bvh=False)``) runs by brute force under
    "auto" and is refused by every other traversal."""
    resolved = traversal
    if traversal == "auto":
        if scene.num_tris <= _BRUTE_MAX_TRIS:
            resolved = "brute"
        elif len(scene.k1_parts) > 0:
            resolved = "pallas2"
        else:
            resolved = "pallas"
    if resolved != "brute" and effective_max_leaf(scene) > _MAX_LEAF:
        if traversal != "auto":
            raise ValueError(
                "scene has BVH leaves over 1024 triangles (was it built "
                "with build_bvh=False?); use traversal='brute'")
        resolved = "brute"
    return resolved


@dataclasses.dataclass
class RenderState:
    """Resumable render state (the reference's accum FBO pair, frame_count
    and tile cursor, screen.py:65-66, main.py:282)."""

    accum: torch.Tensor  # (H, W, 3) float32, top row first
    frame_count: int = 0
    tile_x: int = 0
    tile_y: int = 0
    total_frames: int = 0  # tile draws issued (reference main.py:276)


def state_from_numpy(accum, frame_count: int, tile_x: int, tile_y: int,
                     total_frames: int, device) -> RenderState:
    """RenderState on ``device`` from a NumPy accumulation buffer and the
    JAX package's counters."""
    acc = torch.from_numpy(np.ascontiguousarray(accum, np.float32)).to(device)
    return RenderState(accum=acc, frame_count=int(frame_count),
                       tile_x=int(tile_x), tile_y=int(tile_y),
                       total_frames=int(total_frames))


def render_pixels(scene: SceneData, config: RenderConfig, block, base: int,
                  n: int, n_rays: int, n_band: int, tw: int, raycast_fn,
                  reorder: bool = False, blocks: bool = False,
                  _seed_recon: bool = True):
    """Trace rays ``base .. base + n - 1`` of a step of ``n_rays`` rays
    over a band of ``n_band`` pixels, ``tw`` a row (with ``blocks``, taken
    in 8x16 pixel blocks), at the window, frame number, camera, sky,
    jitter and ``lambertian`` of the step ``block``.  Returns their linear
    color as a 3-tuple of (n,) columns.  With ``reorder`` the rays are
    sorted at ``config.sort_every``'s cadence.

    The reorders are given how G1 seeded each ray (``permute.SeedRecon``,
    the JAX package's ``recon``, ``renderer.py:165-179``), so at one sample
    a pixel (``integrator.trace`` decides) they rebuild each live ray's
    seed from its index instead of moving it; the image is the same bit
    for bit.  In block order they move it, as the JAX step turns ``recon``
    off for blocks (``renderer.py:357-362``); ``_seed_recon=False`` moves
    it too, for the tests that hold the two equal."""
    # pixel, frame, seed, 3 warm-ups, angle-linear ray, 2 jitter draws (G1)
    origin, d, seed = ray_front(block, base, n, n_rays, n_band, tw,
                                config.width, config.height, config.ray_aspect,
                                blocks)
    recon = (SeedRecon(block, base, n_rays, n_band, tw)
             if _seed_recon and not blocks else None)
    color, _ = trace(scene, raycast_fn, origin, d, seed, block,
                     n_bounces=config.n_bounces,
                     rays_per_pixel=config.rays_per_pixel, reorder=reorder,
                     sort_every=config.sort_every, seed_recon=recon)
    return color


def ray_chunk(config: RenderConfig, n_rays: int, traversal: str,
              on_card: bool) -> int:
    """The rays a chunk of a step of ``n_rays``: ``config.ray_chunk`` if
    set, else up to 2M, or 128K for the plain versions of "brute" and
    "bvh" on the CPU; rounded up to whole packets.  Neither of those two
    reorders and a ray's seed comes from its index, so their frames do not
    depend on the chunk."""
    default = (_SMALL_CHUNK if traversal in ("brute", "bvh") and not on_card
               else _DEFAULT_CHUNK)
    chunk = min(config.ray_chunk or min(n_rays, default), n_rays)
    return -(-chunk // PACKET) * PACKET  # whole packets


def render_flat(scene: SceneData, config: RenderConfig, block, n_band: int,
                tw: int, n_frames: int, raycast_fn, traversal: str,
                blocks: bool = False):
    """Chunked render of a step's ``n_frames`` copies of a band of
    ``n_band`` pixels (``tw`` a row; with ``blocks``, each copy in 8x16
    pixel blocks) -> 3 (R,) color columns, R = n_frames * n_band, in
    chunks of :func:`ray_chunk` rays, the last one padded to whole
    packets.  One chunk's columns are the restore's own; several are
    concatenated."""
    R = n_frames * n_band
    chunk = ray_chunk(config, R, traversal, block.is_cuda)
    n_chunks = -(-R // chunk)
    colors = [render_pixels(scene, config, block, c * chunk, chunk, R, n_band,
                            tw, raycast_fn, reorder=traversal in _REORDER,
                            blocks=blocks)
              for c in range(n_chunks)]
    if n_chunks == 1:
        return tuple(x[:R] for x in colors[0])
    return tuple(torch.cat([c[a] for c in colors])[:R] for a in range(3))


def packet_blocks(config: RenderConfig, traversal: str) -> bool:
    """Whether a tile step takes its band's pixels in 8x16 blocks, each a
    128-ray packet: under "packet" when the tile's rows are a multiple of
    8 and its columns of 16, as the JAX step (``renderer.py:322-336``)."""
    return (traversal == "packet" and config.tile_h % BLOCK_H == 0
            and config.tile_w % BLOCK_W == 0)


def band_window(config: RenderConfig, tile_x: int, tile_y: int):
    """(col0, py0, dx0, dy0) of a tile's band: its first column and GL row
    and how many leading columns and rows re-render the previous tile.
    Remainder tiles clamp the window into the frame, and the merge masks
    those leading pixels out (fragment.glsl:382-386, main.py:156-157)."""
    tw, th = config.tile_w, config.tile_h
    col0 = min(tile_x * tw, config.width - tw)
    py0 = min(tile_y * th, config.height - th)
    return col0, py0, tile_x * tw - col0, tile_y * th - py0


def step_words(config: RenderConfig, frame_count: int, tile_x: int,
               tile_y: int, camera: Camera, sky_brightness, jitter_amount,
               lambertian, accum: torch.Tensor | None = None):
    """The step block's words (``step_block.pack``) of one tile step: the
    tile's band window, the frame number and the per-step values, and the
    address of ``accum`` that G6 folds into."""
    col0, py0, dx0, dy0 = band_window(config, tile_x, tile_y)
    row0 = config.height - py0 - config.tile_h
    return step_block.pack(frame_count, (col0, py0, dx0, dy0, row0), camera,
                           sky_brightness, jitter_amount, lambertian,
                           0 if accum is None else accum.data_ptr())


def _tile_step(scene: SceneData, block, accum: torch.Tensor, *,
               config: RenderConfig, raycast_fn, traversal: str) -> None:
    """Render one tile and fold it into ``accum`` in place, every value of
    the step read from its ``block``.

    Frame batching (F > 1): the tile's rays run F times, copy s at frame
    number frame_count + s (G1), and their SUM folds into the running mean
    with weight F (G6).  Under "packet" each copy's rays may be taken in
    8x16 pixel blocks (:func:`packet_blocks`)."""
    F = config.frames_per_step
    tw, th = config.tile_w, config.tile_h
    blocks = packet_blocks(config, traversal)
    colors = render_flat(scene, config, block, tw * th, tw, F, raycast_fn,
                         traversal, blocks)
    fold_band(accum, colors, block, tw, th, F, F, blocks)


def check_accum(accum: torch.Tensor, device, config: RenderConfig) -> None:
    """A step folds into ``accum`` in place, on the card by its address:
    it must be a contiguous (H, W, 3) float32 tensor on ``device``."""
    shape = (config.height, config.width, 3)
    if (accum.device != device or accum.dtype != torch.float32
            or tuple(accum.shape) != shape or not accum.is_contiguous()):
        raise ValueError(f"accum must be a contiguous {shape} float32 tensor "
                         f"on {device}, got {tuple(accum.shape)} "
                         f"{accum.dtype} on {accum.device}")


def advance(config: RenderConfig, state: RenderState,
            frames_per_sweep: int) -> RenderState:
    """The tile cursor after a step (main.py:409-418): the frame count
    advances by ``frames_per_sweep`` after the last tile."""
    tile_x, tile_y, frames = state.tile_x + 1, state.tile_y, state.frame_count
    if tile_x >= config.num_tiles_x:
        tile_x = 0
        tile_y += 1
        if tile_y >= config.num_tiles_y:
            tile_y = 0
            frames += frames_per_sweep
    return RenderState(accum=state.accum, frame_count=frames, tile_x=tile_x,
                       tile_y=tile_y, total_frames=state.total_frames + 1)


class Renderer:
    """Owns the traversal binding and the host-side tile/frame bookkeeping
    (the reference's App.main loop, main.py:273-430, minus windowing).
    ``device`` names where the scene tables, the rays and ``accum`` live;
    CUDA devices run the hand-written kernels, the CPU their plain
    versions.  ``traversal`` is the name the config's one resolved to
    (:func:`resolve_traversal`); ``config`` is the one given with the
    scene's own leaf bound (:func:`resolve_leaf_bound`).  The reorder
    cadence ``config.sort_every`` is fixed for a renderer, so its graph is
    captured with it."""

    def __init__(self, scene, config: RenderConfig = RenderConfig(), *,
                 device):
        # "cuda" names the current card: resolve it to "cuda:<index>" so it
        # compares equal to the device of the tensors placed there
        self.device = torch.empty(0, device=device).device
        scene_data = scene.send(self.device) if isinstance(scene, Scene) \
            else scene
        if scene_data.device != self.device:
            raise ValueError(f"scene lives on {scene_data.device}, renderer "
                             f"on {self.device}")
        self.scene = scene_data
        self.config = config = resolve_leaf_bound(scene_data, config)

        if config.tile_w < 1 or config.tile_h < 1:
            raise ValueError(
                f"tile_size={config.tile_size} exceeds the frame "
                f"({config.width}x{config.height})")

        self.traversal = resolve_traversal(scene_data, config.traversal)
        self._raycast = make_raycast_fn(scene_data, self.traversal,
                                        config.max_leaf_tris)
        self._block = step_block.new(self.device)
        self._graph = None
        self._steps = 0  # the step sequence number of profiling's spans
        # the inputs of the step whose words the block holds, written
        # ahead by the step before it (``_step``), and the stream the write
        # went to; (None, None) where no write is ahead
        self._ahead = (None, None)

    def init_state(self) -> RenderState:
        accum = torch.zeros((self.config.height, self.config.width, 3),
                            dtype=torch.float32, device=self.device)
        return RenderState(accum=accum)

    def reset(self, state: RenderState) -> RenderState:
        """Zero the accumulation and the counters (reference resetFrames,
        main.py:252-271).  ``accum`` is a new buffer, so a copy or a view
        of the old one that a caller still holds is left as it was."""
        return RenderState(accum=torch.zeros_like(state.accum))

    def step(self, state: RenderState, camera: Camera,
             sky_brightness: float | None = None,
             jitter_amount: float | None = None,
             lambertian: bool | None = None) -> RenderState:
        """One tile draw + tile cursor advance (main.py:375-418).
        ``state.accum`` is updated in place and carried into the result.

        On a card the step is one replay of the step's CUDA graph,
        captured at the first step (``step_graph.py``; a capture that
        fails raises), and one write of the step block behind it: the
        words of the step that :func:`advance` predicts, with this step's
        camera and settings.  A step whose inputs (frame count, tile
        cursor, the camera's values, sky, jitter, ``lambertian``,
        ``accum``'s address, the stream) equal that prediction replays at
        once; any other writes its own block first (counters
        ``step.block_ahead_hits`` and ``step.block_ahead_misses``).  On
        the CPU the body runs eagerly, with the same block writes."""
        return self._step(state, camera, sky_brightness, jitter_amount,
                          lambertian, eager=False)

    def _step_eager(self, state: RenderState, camera: Camera,
                    sky_brightness=None, jitter_amount=None,
                    lambertian=None) -> RenderState:
        """:meth:`step` with the body run eagerly, launch by launch: the
        yardstick its replay is held to (chip_smoke.py, the CUDA tests)."""
        return self._step(state, camera, sky_brightness, jitter_amount,
                          lambertian, eager=True)

    def _step(self, state, camera, sky_brightness, jitter_amount, lambertian,
              eager: bool) -> RenderState:
        graphed = self.device.type == "cuda" and not eager
        cfg = self.config
        self._steps += 1
        profiling.set_step(self._steps)
        if graphed and self._graph is None:
            with profiling.Span("step.capture"):
                self._graph = self._capture()
        settings = (
            cfg.sky_brightness if sky_brightness is None else sky_brightness,
            cfg.jitter_amount if jitter_amount is None else jitter_amount,
            bool(cfg.lambertian if lambertian is None else lambertian))
        with profiling.per_step("step.block"):
            check_accum(state.accum, self.device, cfg)
            cam = tuple(v.tobytes() for v in camera)
            stream = self._stream_id()
            (ahead, ahead_stream), self._ahead = self._ahead, (None, None)
            if self._inputs(state, cam, settings, stream) == ahead:
                profiling.count("step.block_ahead_hits")
            else:
                profiling.count("step.block_ahead_misses")
                if ahead is not None and ahead[-1] != stream:
                    # the write ahead went to another stream: it runs first
                    torch.cuda.current_stream(self.device).wait_stream(
                        ahead_stream)
                self._write_block(state, camera, settings)
        if graphed:
            with profiling.per_step("step.replay"):
                self._graph.replay()
        else:
            with profiling.per_step("step.body"):
                self._body(state.accum)
        nxt = advance(cfg, state, cfg.frames_per_step)
        # the next step's block, written behind this step's body while the
        # card renders; the next step reads it if its inputs are these
        self._write_block(nxt, camera, settings)
        self._ahead = (self._inputs(nxt, cam, settings, stream),
                       None if stream is None
                       else torch.cuda.current_stream(self.device))
        return nxt

    @staticmethod
    def _inputs(state: RenderState, cam: tuple, settings: tuple, stream):
        """What a step's block words follow from: its frame count, tile
        cursor, camera (``cam``, each vector's bytes), sky, jitter and
        ``lambertian`` (``settings``), ``accum``'s address, and the stream
        its block is written on."""
        return (state.frame_count, state.tile_x, state.tile_y, cam, settings,
                state.accum.data_ptr(), stream)

    def _write_block(self, state: RenderState, camera: Camera,
                     settings: tuple) -> None:
        step_block.write(self._block, step_words(
            self.config, state.frame_count, state.tile_x, state.tile_y,
            camera, *settings, state.accum))

    def _stream_id(self):
        """The current stream of the step's card, as (stream id, device
        index, device type), or None on the CPU: the private call costs a
        few us where ``torch.cuda.current_stream`` builds a Stream."""
        return (torch._C._cuda_getCurrentStream(self.device.index)
                if self.device.type == "cuda" else None)

    def _body(self, accum: torch.Tensor) -> None:
        _tile_step(self.scene, self._block, accum, config=self.config,
                   raycast_fn=self._raycast, traversal=self.traversal)

    def _capture(self):
        """The step's graph.  Its warm-up step folds into a scratch buffer
        (the block names it), never into a caller's ``accum``."""
        cfg = self.config
        scratch = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                              device=self.device)
        self._ahead = (None, None)  # the warm-up writes the block

        def warmup():
            step_block.write(self._block, step_words(
                cfg, 0, 0, 0, make_camera(DEFAULT_CAM_POS, DEFAULT_CAM_DIR),
                cfg.sky_brightness, cfg.jitter_amount, cfg.lambertian,
                scratch))
            self._body(scratch)

        return step_graph.capture(lambda: self._body(scratch), self.device,
                                  warmup)

    def render(self, camera: Camera | None = None, frames: int = 1,
               state: RenderState | None = None,
               cam_pos=None, cam_dir=None) -> RenderState:
        """Run ``frames`` full progressive sweeps and return the state.
        Without ``camera``, the camera is made from ``cam_pos`` and
        ``cam_dir``, each defaulting to the reference's preset pose."""
        if camera is None:
            camera = make_camera(
                DEFAULT_CAM_POS if cam_pos is None else cam_pos,
                DEFAULT_CAM_DIR if cam_dir is None else cam_dir)
        if state is None:
            state = self.init_state()
        F = self.config.frames_per_step
        if frames % F:
            raise ValueError(
                f"frames={frames} must be a multiple of frames_per_step={F} "
                f"(each sweep converges {F} frames)")
        tiles = self.config.num_tiles_x * self.config.num_tiles_y
        for _ in range((frames // F) * tiles):
            state = self.step(state, camera)
        return state

    @staticmethod
    def image(state: RenderState) -> np.ndarray:
        """A copy of the accumulated frame as (H, W, 3) float32, top row
        first (``accum`` itself changes in place with every step)."""
        return state.accum.to("cpu", copy=True).numpy()
