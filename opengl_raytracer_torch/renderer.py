"""Progressive tile renderer.

The port of ``opengl_raytracer_tpu/renderer.py``:

* the per-pixel front (seed, three warm-ups, angle-linear ray, two jitter
  draws) follows fragment.glsl ``main()`` (fragment.glsl:376-407); it is
  ``ops/front.py:ray_front``, one kernel launch a chunk on the card;
* progressive accumulation is the running mean ``(prev * frameNumber +
  curr) / (frameNumber + F)`` (fragment.glsl:409-414);
* one ``(W/tiles) x (H/tiles)`` band renders per step, and the frame
  counter advances after a full sweep (main.py:409-418).  Remainder tiles
  clamp the band into the frame and mask the merge.

``accum`` is updated IN PLACE by every step, the analogue of the JAX
package's buffer donation (its ``jax.jit(..., donate_argnums=(2,))``): a
caller that keeps an image across steps copies it first.  ``accum`` is
stored top-row-first; ray generation uses GL bottom-up pixel coordinates.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opengl_raytracer_torch.models.scene import Scene, SceneData
from opengl_raytracer_torch.ops.camera import Camera, make_camera
from opengl_raytracer_torch.ops.front import ray_front
from opengl_raytracer_torch.ops.integrator import trace
from opengl_raytracer_torch.ops.intersect import raycast_brute
from opengl_raytracer_torch.ops.pallas_traversal import raycast_pallas
from opengl_raytracer_torch.ops.subblock_traversal import raycast_subblock
from opengl_raytracer_torch.ops.traversal import raycast_bvh
from opengl_raytracer_torch.presets import DEFAULT_CAM_DIR, DEFAULT_CAM_POS
from opengl_raytracer_torch.utils.config import SKY_COLOR, RenderConfig

_PACKET = 128  # chunks round up to whole 128-ray packets, as in the JAX package
_DEFAULT_CHUNK = 2 * 1024 * 1024
# brute force's (R, 2048) intermediates and the BVH walk's per-ray state
# bound their chunks, as in the JAX package (renderer.py:239-241)
_SMALL_CHUNK = 128 * 1024
_BRUTE_MAX_TRIS = 128  # "auto" picks brute force up to this many triangles
_MAX_LEAF = 1024  # larger leaves (build_bvh=False) only by brute force
_REORDER = ("packet", "pallas", "pallas2")


def effective_max_leaf(scene: SceneData) -> int:
    """The leaf-loop bound of this scene's BVH, from its own node table
    (``opengl_raytracer_tpu/renderer.py:53-76``): a smaller bound would
    skip triangles, a larger one would read past the slack of the wide
    kernel's octet table."""
    count = scene.node_count
    return int(count.max()) if count.numel() else 1


def make_raycast_fn(scene: SceneData, traversal: str, max_leaf_tris: int):
    """Bind ``raycast(o3, d3, active) -> Nearest`` for the chosen
    traversal: "brute" (dense sweep), "bvh" (per-ray stackless walk),
    "pallas" and "packet" (both the wide-BVH kernel, K3) or "pallas2" (the
    sub-block kernel, K1).  ``max_leaf_tris`` must cover the scene's
    largest leaf (:func:`effective_max_leaf`)."""
    if traversal == "brute":
        return lambda o3, d3, active=None: raycast_brute(scene, o3, d3, active)
    if traversal == "bvh":
        return lambda o3, d3, active=None: raycast_bvh(
            scene, o3, d3, active, max_leaf_tris=max_leaf_tris)
    if traversal in ("pallas", "packet"):
        return lambda o3, d3, active=None: raycast_pallas(
            scene, o3, d3, active, max_leaf_tris=max_leaf_tris)
    if traversal == "pallas2":
        return lambda o3, d3, active=None: raycast_subblock(scene, o3, d3,
                                                            active)
    raise ValueError(f"unknown traversal {traversal!r}")


def resolve_traversal(scene: SceneData, traversal: str) -> str:
    """The traversal a ``RenderConfig.traversal`` name runs on ``scene``.

    "auto" follows the JAX package (``renderer.py:415-464``): brute force
    for scenes of at most 128 (padded) triangles, else the sub-block
    kernel "pallas2" when the scene has its tables, else the wide-BVH
    kernel "pallas".  The JAX package's 13 MB bound between "pallas" and
    "packet" is the TPU's VMEM budget for the wide kernel's tables; it does
    not apply on the card, where both names run K3.  Last, a scene with a
    leaf over 1024 triangles (``Scene(build_bvh=False)``) runs by brute
    force under "auto" and is refused by every other traversal."""
    resolved = traversal
    if traversal == "auto":
        if scene.num_tris <= _BRUTE_MAX_TRIS:
            resolved = "brute"
        elif scene.p2_node_rows.shape[0] > 0:
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


def render_pixels(scene: SceneData, config: RenderConfig, camera: Camera,
                  frame_number, sky_brightness: float, jitter_amount: float,
                  lambertian: bool, px, py, raycast_fn,
                  reorder: bool = False):
    """Trace a flat batch of pixels; px/py int (R,) tensors, py in GL
    convention (0 = bottom row); ``frame_number`` an int or an (R,)
    tensor.  Returns (R, 3) linear color."""
    # seed, 3 warm-ups, angle-linear ray, 2 jitter draws (G1)
    origin, d, seed = ray_front(px, py, frame_number, camera, config.width,
                                config.height, config.ray_aspect,
                                jitter_amount)
    sky = tuple(float(c) for c in
                np.asarray(SKY_COLOR, np.float32) * np.float32(sky_brightness))
    color, _ = trace(scene, raycast_fn, origin, d, seed, sky,
                     n_bounces=config.n_bounces,
                     rays_per_pixel=config.rays_per_pixel,
                     lambertian=bool(lambertian), reorder=reorder)
    return color


def render_flat(scene: SceneData, config: RenderConfig, camera: Camera,
                frame_count, sky_brightness, jitter_amount, lambertian,
                px, py, raycast_fn, traversal: str):
    """Chunked render of a flat pixel list -> (R, 3) colors.  Chunks of up
    to 2M rays for the kernels' traversals and 128K for "brute" and "bvh"
    (or ``config.ray_chunk``) bound the per-ray state."""
    R = px.shape[0]
    default = (_SMALL_CHUNK if traversal in ("brute", "bvh")
               else _DEFAULT_CHUNK)
    chunk = min(config.ray_chunk or min(R, default), R)
    chunk = -(-chunk // _PACKET) * _PACKET
    n_chunks = -(-R // chunk)
    pad = n_chunks * chunk - R
    frame_is_tensor = isinstance(frame_count, torch.Tensor)
    if pad:
        px = torch.cat([px, px.new_zeros(pad)])
        py = torch.cat([py, py.new_zeros(pad)])
        if frame_is_tensor:
            frame_count = torch.cat([frame_count, frame_count.new_zeros(pad)])
    colors = []
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        frame_c = frame_count[sl] if frame_is_tensor else frame_count
        colors.append(render_pixels(
            scene, config, camera, frame_c, sky_brightness, jitter_amount,
            lambertian, px[sl], py[sl], raycast_fn,
            reorder=traversal in _REORDER))
    return torch.cat(colors)[:R]


def band_window(config: RenderConfig, tile_x: int, tile_y: int):
    """(col0, py0, dx0, dy0) of a tile's band: its first column and GL row
    and how many leading columns and rows re-render the previous tile.
    Remainder tiles clamp the window into the frame, and the merge masks
    those leading pixels out (fragment.glsl:382-386, main.py:156-157)."""
    tw, th = config.tile_w, config.tile_h
    col0 = min(tile_x * tw, config.width - tw)
    py0 = min(tile_y * th, config.height - th)
    return col0, py0, tile_x * tw - col0, tile_y * th - py0


def band_pixels(col0: int, py0: int, tw: int, rows: int, device):
    """Row-major (px, py) int64 (rows * tw,) of ``rows`` band rows from GL
    row ``py0``, columns ``col0 .. col0 + tw - 1``."""
    cols = torch.arange(tw, dtype=torch.int64, device=device)
    ys = torch.arange(rows, dtype=torch.int64, device=device)
    return ((col0 + cols)[None, :].expand(rows, tw).reshape(-1),
            (py0 + ys)[:, None].expand(rows, tw).reshape(-1))


def fold_band(accum: torch.Tensor, colors: torch.Tensor, config: RenderConfig,
              window, frame_count: int, weight: int) -> None:
    """Fold a band's (th * tw, 3) color sum, row-major from its bottom GL
    row, into ``accum`` in place: ``(prev * fc + colors) / (fc + weight)``
    where the window's mask is set."""
    col0, py0, dx0, dy0 = window
    tw, th = config.tile_w, config.tile_h
    dev = accum.device
    # GL py ascends bottom-up; accum rows descend top-down.
    tile_img = colors.reshape(th, tw, 3).flip(0)
    row0 = config.height - py0 - th
    valid = ((torch.arange(tw, device=dev)[None, :] >= dx0)
             & (torch.arange(th, device=dev)[:, None] >= dy0))
    mask_img = valid.flip(0)[:, :, None]

    prev = accum[row0:row0 + th, col0:col0 + tw]
    fc = float(frame_count)
    merged = torch.where(mask_img, (prev * fc + tile_img) / (fc + weight),
                         prev)
    prev.copy_(merged)


def _tile_step(scene: SceneData, camera: Camera, accum: torch.Tensor,
               frame_count: int, tile_x: int, tile_y: int,
               sky_brightness, jitter_amount, lambertian, *,
               config: RenderConfig, raycast_fn, traversal: str) -> None:
    """Render one tile and fold it into ``accum`` in place."""
    dev = accum.device
    window = band_window(config, tile_x, tile_y)
    px, py = band_pixels(window[0], window[1], config.tile_w, config.tile_h,
                         dev)

    # Frame batching (F > 1): replicate the tile's rays F times, seed copy
    # s with frame number frame_count + s, and fold the SUM into the
    # running mean with weight F.
    F = config.frames_per_step
    n_band = px.shape[0]
    if F > 1:
        px = px.repeat(F)
        py = py.repeat(F)
        frames = frame_count + torch.arange(
            F, dtype=torch.int64, device=dev).repeat_interleave(n_band)
    else:
        frames = frame_count

    colors = render_flat(scene, config, camera, frames, sky_brightness,
                         jitter_amount, lambertian, px, py, raycast_fn,
                         traversal)
    if F > 1:
        colors = colors.reshape(F, n_band, 3).sum(dim=0)
    fold_band(accum, colors, config, window, frame_count, F)


class Renderer:
    """Owns the traversal binding and the host-side tile/frame bookkeeping
    (the reference's App.main loop, main.py:273-430, minus windowing).
    ``device`` names where the scene tables, the rays and ``accum`` live;
    CUDA devices run the hand-written kernels, the CPU their plain
    versions.  ``traversal`` is the name the config's one resolved to
    (:func:`resolve_traversal`)."""

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
        self.config = config

        if config.tile_w < 1 or config.tile_h < 1:
            raise ValueError(
                f"tile_size={config.tile_size} exceeds the frame "
                f"({config.width}x{config.height})")

        self.traversal = resolve_traversal(scene_data, config.traversal)
        self._raycast = make_raycast_fn(scene_data, self.traversal,
                                        effective_max_leaf(scene_data))

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
        ``state.accum`` is updated in place and carried into the result."""
        cfg = self.config
        _tile_step(
            self.scene, camera, state.accum, state.frame_count,
            state.tile_x, state.tile_y,
            cfg.sky_brightness if sky_brightness is None else sky_brightness,
            cfg.jitter_amount if jitter_amount is None else jitter_amount,
            cfg.lambertian if lambertian is None else lambertian,
            config=cfg, raycast_fn=self._raycast, traversal=self.traversal)

        tile_x, tile_y, frames = state.tile_x + 1, state.tile_y, state.frame_count
        if tile_x >= cfg.num_tiles_x:
            tile_x = 0
            tile_y += 1
            if tile_y >= cfg.num_tiles_y:
                tile_y = 0
                frames += cfg.frames_per_step
        return RenderState(accum=state.accum, frame_count=frames,
                           tile_x=tile_x, tile_y=tile_y,
                           total_frames=state.total_frames + 1)

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
