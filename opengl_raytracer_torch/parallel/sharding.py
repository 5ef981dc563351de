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
  its slice of the band's pixels and its frame number, issued one after
  another from the calling thread.  Kernel launches return at once, so
  shards on distinct cards overlap on the devices, but the host enqueues
  them in turn (about 700 launches a shard at 1080p).
* ``accum`` lives on the mesh's first device (the home device), not
  row-sharded over dp (the JAX ``P("dp")``).  The shards' colors are
  copied there, summed in sp index order and folded into ``accum`` in
  place, as ``renderer._tile_step`` folds a band.  A 1080p ``accum`` is
  25 MB; keeping it in one place makes ``image()``, ``restore_state`` and
  checkpoints plain copies.
* The scene is uploaded once per distinct device, so a mesh that repeats
  one card holds one copy of the tables.
* ``"auto"`` resolves with the port's ``resolve_traversal``, as the
  port's ``Renderer`` does: ``"pallas2"`` (K1 + K2) on scenes with
  sub-block tables.  The JAX module picks ``"packet"`` for those off a TPU
  (``sharding.py:174-185``).
* The JAX step passes ``render_flat`` a seed-reconstruction descriptor
  (``sharding.py:108-112``); the port's integrator carries each ray's
  seed through its gathers instead, so per-ray results do not depend on
  which shard holds the ray, and no descriptor is needed.

Devices: by default every CUDA card, ``cuda:0 .. cuda:{n-1}``.  A mesh of
CPU devices, or one that repeats a card, is made only by naming its
devices in :func:`make_mesh`'s ``devices``.
"""

from __future__ import annotations

import numpy as np
import torch

from opengl_raytracer_torch.models.scene import Scene, SceneData
from opengl_raytracer_torch.ops.camera import Camera, make_camera
from opengl_raytracer_torch.presets import DEFAULT_CAM_DIR, DEFAULT_CAM_POS
from opengl_raytracer_torch.renderer import (RenderState, band_pixels,
                                             band_window, effective_max_leaf,
                                             fold_band, make_raycast_fn,
                                             render_flat, resolve_traversal)
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


def _device(d) -> torch.device:
    """``d`` as a torch.device; a bare "cuda" names the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


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
    devices = [_device(d) for d in devices]
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


def sharded_tile_step(scenes: dict, raycasts: dict, camera: Camera,
                      accum: torch.Tensor, frame_count: int, tile_x: int,
                      tile_y: int, sky_brightness, jitter_amount, lambertian,
                      *, config: RenderConfig, traversal: str,
                      mesh: Mesh) -> None:
    """One mesh step: render one tile band, rows split over ``dp`` and
    frame numbers over ``sp``, and fold it into ``accum`` (on its own
    device) in place.

    ``scenes`` and ``raycasts`` map each mesh device to its copy of the
    scene and its traversal.  The band's clamp and remainder mask are
    ``_tile_step``'s (``renderer.band_window`` and ``fold_band``), so the
    image equals the sequential renderer's."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    tw, rows = config.tile_w, config.tile_h // dp
    home = accum.device
    window = band_window(config, tile_x, tile_y)
    col0, py0 = window[0], window[1]
    slices = []
    for i in range(dp):
        total = None
        for s in range(sp):
            dev = mesh.devices[i, s]
            px, py = band_pixels(col0, py0 + i * rows, tw, rows, dev)
            colors = render_flat(scenes[dev], config, camera, frame_count + s,
                                 sky_brightness, jitter_amount, lambertian,
                                 px, py, raycasts[dev], traversal).to(home)
            total = colors if total is None else total + colors
        slices.append(total)
    fold_band(accum, torch.cat(slices), config, window, frame_count, sp)


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
        self.config = config
        self.mesh = mesh
        self.home = mesh.devices[0, 0]
        self.scenes = {dev: _scene_on(scene, dev)
                       for dev in dict.fromkeys(mesh.devices.flat)}
        self.scene = self.scenes[self.home]
        self.traversal = resolve_traversal(self.scene, config.traversal)
        leaf = effective_max_leaf(self.scene)
        self._raycasts = {dev: make_raycast_fn(data, self.traversal, leaf)
                          for dev, data in self.scenes.items()}
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
        ``state.accum`` is updated in place and carried into the result."""
        cfg = self.config
        sharded_tile_step(
            self.scenes, self._raycasts, camera, state.accum,
            state.frame_count, state.tile_x, state.tile_y,
            cfg.sky_brightness if sky_brightness is None else sky_brightness,
            cfg.jitter_amount if jitter_amount is None else jitter_amount,
            cfg.lambertian if lambertian is None else lambertian,
            config=cfg, traversal=self.traversal, mesh=self.mesh)
        tile_x, tile_y, frames = state.tile_x + 1, state.tile_y, state.frame_count
        if tile_x >= cfg.num_tiles_x:
            tile_x = 0
            tile_y += 1
            if tile_y >= cfg.num_tiles_y:
                tile_y = 0
                frames += self.frames_per_step
        return RenderState(accum=state.accum, frame_count=frames,
                           tile_x=tile_x, tile_y=tile_y,
                           total_frames=state.total_frames + 1)

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
