"""Multi-device rendering over a (dp, sp) mesh of torch devices.

The port of ``opengl_raytracer_tpu/parallel/sharding.py``, with its two
mesh axes:

* ``dp`` (pixel parallel): the rays of the current tile band are split
  into dp contiguous slices of whole band rows, one per dp index;
* ``sp`` (sample parallel): the device at sp index ``s`` renders frame
  number ``frame_count + s``, and the sp results are summed (the JAX
  package's ``psum``).  The per-pixel RNG stream depends only on (x, y,
  frameNumber) (fragment.glsl:390), so sp devices converge the
  accumulation sp frames per step with the samples of sp sequential
  frames.

One step renders one tile band across the whole mesh, so
:class:`ShardedRenderer` has the ``Renderer``'s ``init_state / step /
render / image`` surface and shares its ``RenderState`` and checkpoints.

Design, and where it departs from the JAX module:

* One process drives every device, as the JAX package's single controller
  does; there is no ``torch.distributed``.  The CLI stays one process.
  Each (dp, sp) shard is the port's ``render_flat`` on its own device, with
  its slice of the band's rows and its frame number in its own step block
  (``ops/step_block.py``), issued one after another from the calling
  thread.  On cards each shard's body is one CUDA graph, captured at its
  first step (``step_graph.py``; the JAX package jits its
  ``shard_map``ped step, ``sharding.py:119-126``), so a shard costs the
  host one block write and one replay; shards on distinct cards overlap
  on the devices.
* ``accum`` lives on the mesh's first device (the home device), not
  row-sharded over dp (the JAX ``P("dp")``).  The shards' colors are
  copied there, summed in sp index order and folded into ``accum`` in
  place (G6, ``ops/fold.py``), eagerly: a handful of launches a step.  A
  1080p ``accum`` is 25 MB; keeping it in one place makes ``image()``,
  ``restore_state`` and checkpoints plain copies.
* The scene is uploaded once per distinct device, so a mesh that repeats
  one card holds one copy of the tables.
* ``"auto"`` resolves with the port's ``resolve_traversal``, as the
  port's ``Renderer`` does: ``"pallas2"`` (K1 + K2) on scenes with
  sub-block tables.  The JAX module picks ``"packet"`` for those off a TPU
  (``sharding.py:174-185``).  Under an explicit ``"packet"`` a shard runs
  the packet walk (G9) over its rows in row-major order, as the JAX
  mesh's bands are not blocked (its step has no 8x16 pixel order).
* The JAX step passes ``render_flat`` a seed-reconstruction descriptor
  (``sharding.py:108-112``).  The port's is each shard's own:
  ``render_pixels`` builds it from the arguments it hands G1 (the
  chunk's base, the shard's rays, band and row width) and the shard's
  step block, whose window starts at the shard's first row and whose
  frame number is the shard's, so a shard rebuilds its rays' seeds as
  its G1 made them.

Devices: by default every CUDA card, ``cuda:0 .. cuda:{n-1}``.  A mesh of
CPU devices, or one that repeats a card, is made only by naming its
devices in :func:`make_mesh`'s ``devices``.
"""

from __future__ import annotations

import numpy as np
import torch

from opengl_raytracer_torch import step_graph
from opengl_raytracer_torch.models.scene import Scene, SceneData, torch_device
from opengl_raytracer_torch.ops import step_block
from opengl_raytracer_torch.ops.camera import Camera, make_camera
from opengl_raytracer_torch.ops.fold import fold_band
from opengl_raytracer_torch.presets import DEFAULT_CAM_DIR, DEFAULT_CAM_POS
from opengl_raytracer_torch.renderer import (RenderState, advance,
                                             band_window, check_accum,
                                             make_raycast_fn, render_flat,
                                             resolve_leaf_bound,
                                             resolve_traversal, step_words)
from opengl_raytracer_torch.utils.config import RenderConfig


class Mesh:
    """A (dp, sp) grid of torch devices: ``devices`` is a (dp, sp) object
    array and ``shape`` maps "dp" and "sp" to its sizes, as a
    ``jax.sharding.Mesh`` has them."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty (dp, sp) grid, got "
                             f"shape {devices.shape}")
        self.devices = devices
        self.shape = {"dp": devices.shape[0], "sp": devices.shape[1]}


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              sp: int | None = None, devices=None) -> Mesh:
    """Build a (dp, sp) device mesh over the first ``n_devices`` of
    ``devices`` (default: every CUDA card).  Defaults: sp = 2 when the
    device count is even and > 1, else 1; dp = the rest.  Raises
    ValueError when more devices are asked for than exist, when sp does
    not divide the count, or when dp * sp differs from it."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch_device(d) for d in devices]
    platform = devices[0].type if devices else "cuda"
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices but only "
                             f"{len(devices)} available on platform "
                             f"{platform}")
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0:
        raise ValueError(f"no {platform} device available; name the mesh's "
                         f"devices (devices=['cpu'] renders on the CPU)")
    if sp is None:
        sp = 2 if (dp is None and n % 2 == 0 and n > 1) else 1
    if dp is None:
        if n % sp:
            raise ValueError(f"sp={sp} does not divide device count {n}")
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(dp, sp))


class _Shard:
    """One (dp, sp) shard of a mesh: its device, its copy of the scene and
    its traversal, its step block, and the rows of the band it renders.
    On a card its body is captured once, into a memory pool shared with
    the other shards of its device, and replayed every step."""

    def __init__(self, scene, raycast_fn, config: RenderConfig,
                 traversal: str, rows: int, pool):
        self.scene, self.raycast_fn = scene, raycast_fn
        self.config, self.traversal, self.rows = config, traversal, rows
        self.device = scene.device
        self.block = step_block.new(self.device)
        self.pool = pool
        self.graph = None

    def body(self):
        tw = self.config.tile_w
        return render_flat(self.scene, self.config, self.block,
                           tw * self.rows, tw, 1, self.raycast_fn,
                           self.traversal)

    def run(self, words, eager: bool = False):
        """Write the shard's block and render its rows -> 3 color columns
        (in the graph's pool when replayed: read them before the next
        replay)."""
        graphed = self.device.type == "cuda" and not eager
        if graphed and self.graph is None:
            self.graph = step_graph.capture(self.body, self.device,
                                            pool=self.pool)
        step_block.write(self.block, words)
        return self.graph.replay() if graphed else self.body()


def sharded_tile_step(shards, home_block, state: RenderState, camera: Camera,
                      sky_brightness, jitter_amount, lambertian, *,
                      config: RenderConfig, mesh: Mesh,
                      eager: bool = False) -> None:
    """One mesh step: render one tile band, rows split over ``dp`` and
    frame numbers over ``sp``, and fold it into ``state.accum`` (on its
    own device) in place.

    ``shards`` is the (dp, sp) grid of :class:`_Shard`; shard (i, s)
    renders rows ``i * tile_h / dp ..`` of the band at frame number
    ``frame_count + s``, each value in its own step block.  The colors
    are copied to the home device, summed in sp index order and folded
    (G6, weight sp) at the window of ``home_block``: the band's clamp and
    remainder mask are ``_tile_step``'s (``renderer.band_window``), so the
    image equals the sequential renderer's."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    rows = config.tile_h // dp
    accum = state.accum
    home = accum.device
    col0, py0, _, _ = band_window(config, state.tile_x, state.tile_y)
    slices = []
    for i in range(dp):
        total = None
        for s in range(sp):
            words = step_block.pack(state.frame_count + s,
                                    (col0, py0 + i * rows, 0, 0, 0), camera,
                                    sky_brightness, jitter_amount, lambertian)
            colors = tuple(c.to(home) for c in shards[i][s].run(words, eager))
            total = colors if total is None else tuple(
                a + b for a, b in zip(total, colors))
        slices.append(total)
    colors = slices[0] if dp == 1 else tuple(
        torch.cat([sl[a] for sl in slices]) for a in range(3))
    step_block.write(home_block, step_words(
        config, state.frame_count, state.tile_x, state.tile_y, camera,
        sky_brightness, jitter_amount, lambertian, accum))
    fold_band(accum, colors, home_block, config.tile_w, config.tile_h, 1, sp)


def _scene_on(scene, device: torch.device) -> SceneData:
    """``scene`` on ``device``: a Scene is uploaded there; SceneData must
    already lie there, as the ``Renderer`` requires."""
    data = scene.send(device) if isinstance(scene, Scene) else scene
    if data.device != device:
        raise ValueError(f"scene lives on {data.device}, mesh device "
                         f"{device}; pass a Scene to upload it to each")
    return data


class ShardedRenderer:
    """Progressive renderer over a device mesh, with the ``Renderer``'s
    state/step/render surface.

    Each ``step`` renders one tile band and advances the accumulation by
    ``sp`` frames (``frames_per_step``); a full tile sweep therefore
    converges ``sp`` frames.  ``accum`` lives on ``home`` (the mesh's first
    device) and is updated in place by every step; ``RenderState``
    round-trips through ``utils.checkpoint``, and :meth:`restore_state`
    moves a loaded state's ``accum`` home."""

    def __init__(self, scene, config: RenderConfig, mesh: Mesh):
        if config.frames_per_step != 1:
            raise ValueError(
                "frames_per_step > 1 is the single-device frame-batching "
                "path; on a mesh, use the sp axis for frame parallelism")
        if config.tile_w < 1 or config.tile_h < 1:
            raise ValueError(
                f"tile_size={config.tile_size} exceeds the frame "
                f"({config.width}x{config.height})")
        dp = mesh.shape["dp"]
        if config.height % dp:
            raise ValueError(f"dp={dp} must divide height {config.height}")
        if config.tile_h % dp:
            raise ValueError(
                f"dp={dp} must divide the tile band height {config.tile_h} "
                f"(tile_size={config.tile_size})")
        self.mesh = mesh
        self.home = mesh.devices[0, 0]
        self.scenes = {dev: _scene_on(scene, dev)
                       for dev in dict.fromkeys(mesh.devices.flat)}
        self.scene = self.scenes[self.home]
        # the scene's own leaf bound, as the Renderer keeps it (JAX
        # sharding.py:157); each shard's graph holds the config's cadence
        self.config = config = resolve_leaf_bound(self.scene, config)
        self.traversal = resolve_traversal(self.scene, config.traversal)
        raycasts = {dev: make_raycast_fn(data, self.traversal,
                                         config.max_leaf_tris)
                    for dev, data in self.scenes.items()}
        pools = {dev: torch.cuda.graph_pool_handle()
                 if dev.type == "cuda" else None for dev in self.scenes}
        self._shards = [[_Shard(self.scenes[dev], raycasts[dev], config,
                                self.traversal, config.tile_h // dp,
                                pools[dev])
                         for dev in row] for row in mesh.devices]
        self._home_block = step_block.new(self.home)
        self.frames_per_step = mesh.shape["sp"]

    def init_state(self) -> RenderState:
        cfg = self.config
        return RenderState(accum=torch.zeros(
            (cfg.height, cfg.width, 3), dtype=torch.float32, device=self.home))

    def restore_state(self, state: RenderState) -> RenderState:
        """A copy of a (checkpoint-loaded) state with its ``accum`` on the
        home device, ready to step."""
        return RenderState(
            accum=state.accum.to(self.home, torch.float32, copy=True),
            frame_count=state.frame_count, tile_x=state.tile_x,
            tile_y=state.tile_y, total_frames=state.total_frames)

    def reset(self, state: RenderState) -> RenderState:
        """Zeroed counters and a NEW zeroed ``accum`` (a copy or view of the
        old one that a caller holds is left as it was)."""
        return RenderState(accum=torch.zeros_like(state.accum))

    def step(self, state: RenderState, camera: Camera,
             sky_brightness: float | None = None,
             jitter_amount: float | None = None,
             lambertian: bool | None = None) -> RenderState:
        """One tile band across the mesh + tile cursor advance;
        ``state.accum`` is updated in place and carried into the result.
        On cards each shard is one block write and one graph replay
        (captured at its first step); the sum and the fold run on the home
        device."""
        return self._step(state, camera, sky_brightness, jitter_amount,
                          lambertian, eager=False)

    def _step_eager(self, state: RenderState, camera: Camera,
                    sky_brightness=None, jitter_amount=None,
                    lambertian=None) -> RenderState:
        """:meth:`step` with every shard's body run eagerly: the yardstick
        the replays are held to (chip_smoke.py, the CUDA tests)."""
        return self._step(state, camera, sky_brightness, jitter_amount,
                          lambertian, eager=True)

    def _step(self, state, camera, sky_brightness, jitter_amount,
              lambertian, eager: bool) -> RenderState:
        cfg = self.config
        check_accum(state.accum, self.home, cfg)
        sharded_tile_step(
            self._shards, self._home_block, state, camera,
            cfg.sky_brightness if sky_brightness is None else sky_brightness,
            cfg.jitter_amount if jitter_amount is None else jitter_amount,
            cfg.lambertian if lambertian is None else lambertian,
            config=cfg, mesh=self.mesh, eager=eager)
        return advance(cfg, state, self.frames_per_step)

    def render(self, camera: Camera | None = None, frames: int = 1,
               state: RenderState | None = None) -> RenderState:
        """Run enough sweeps to converge ``frames`` progressive frames (a
        multiple of sp); without ``camera``, the reference's preset pose."""
        if camera is None:
            camera = make_camera(DEFAULT_CAM_POS, DEFAULT_CAM_DIR)
        if state is None:
            state = self.init_state()
        if frames % self.frames_per_step:
            raise ValueError(
                f"frames={frames} must be a multiple of sp="
                f"{self.frames_per_step} (each sweep converges sp frames)")
        tiles = self.config.num_tiles_x * self.config.num_tiles_y
        for _ in range((frames // self.frames_per_step) * tiles):
            state = self.step(state, camera)
        return state

    @staticmethod
    def image(state: RenderState) -> np.ndarray:
        """A copy of the accumulated frame as (H, W, 3) float32, top row
        first."""
        return state.accum.to("cpu", copy=True).numpy()
