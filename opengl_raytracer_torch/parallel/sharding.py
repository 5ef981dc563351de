"""Multi-device rendering over a (dp, sp) mesh of torch devices.

The port of ``opengl_raytracer_tpu/parallel/sharding.py``, with its two
mesh axes:

* ``dp`` (pixel parallel): the rays of the current tile band are split
  into dp contiguous pieces of whole band rows, one per dp index, and the
  accumulation buffer into dp slices of whole image rows;
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
  its piece of the band's rows and its frame number in its own step block
  (``ops/step_block.py``), issued one after another from the calling
  thread, every shard before any copy.  On cards each shard's body is one
  CUDA graph, captured at its first step (``step_graph.py``; the JAX
  package jits its ``shard_map``ped step, ``sharding.py:119-126``), so a
  shard costs the host one replay, its block written ahead by the step
  before (as ``Renderer.step`` writes its own); shards on distinct cards
  overlap on the devices.
* ``accum`` is a :class:`RowShardedAccum`: slice j holds image rows
  ``j * H/dp ..`` on ``devices[j, 0]``, the JAX ``P("dp")``
  (``sharding.py:195``).  The JAX array is replicated over sp; the port
  keeps one copy a dp row, on its sp=0 device.  Where GSPMD reshards the
  band into the slices (``sharding.py:129-138``), the port routes it by
  hand (:func:`plan_step`): each dp row sums its shards' colours on its
  sp=0 device in sp index order, each run of its rows goes to the slice
  that holds them, and G6 (``ops/fold.py``) folds it there, eagerly, with
  the slice's own step block.  Dp row i renders the rows of slice i when
  the band is the whole frame (``tile_size=1``), so such a step copies
  nothing between dp rows.
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

from typing import NamedTuple

import numpy as np
import torch

from opengl_raytracer_torch import step_graph
from opengl_raytracer_torch.models.scene import Scene, SceneData, torch_device
from opengl_raytracer_torch.ops import step_block
from opengl_raytracer_torch.ops.camera import Camera, make_camera
from opengl_raytracer_torch.ops.fold import check_target, fold_band
from opengl_raytracer_torch.presets import DEFAULT_CAM_DIR, DEFAULT_CAM_POS
from opengl_raytracer_torch.renderer import (RenderState, advance,
                                             band_window, make_raycast_fn,
                                             render_flat, resolve_leaf_bound,
                                             resolve_traversal)
from opengl_raytracer_torch.utils import profiling
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


class RowShardedAccum:
    """A mesh's accumulation buffer, the (H, W, 3) float32 frame (top row
    first) as dp row slices: ``slices[j]`` is a contiguous (H/dp, W, 3)
    tensor of image rows ``j * H/dp .. (j+1) * H/dp - 1`` on the mesh's
    ``devices[j, 0]``.  ``cpu()`` gathers the frame into a new host tensor
    (checkpoints save ``state.accum.cpu().numpy()``)."""

    def __init__(self, slices):
        self.slices = tuple(slices)

    @classmethod
    def zeros(cls, devices, height: int, width: int) -> "RowShardedAccum":
        """Zeroed slices of a ``height`` x ``width`` frame, one on each of
        ``devices``."""
        rows = height // len(devices)
        return cls(torch.zeros((rows, width, 3), dtype=torch.float32,
                               device=dev) for dev in devices)

    @classmethod
    def scatter(cls, frame: torch.Tensor, devices) -> "RowShardedAccum":
        """New slices holding a copy of ``frame`` (H, W, 3), one on each of
        ``devices``."""
        rows = frame.shape[0] // len(devices)
        return cls(frame[j * rows:(j + 1) * rows].to(dev, torch.float32,
                                                     copy=True).contiguous()
                   for j, dev in enumerate(devices))

    def cpu(self) -> torch.Tensor:
        return torch.cat([s.cpu() for s in self.slices])


class Part(NamedTuple):
    """A run of band rows that one dp row renders and one slice folds:
    rays ``lo * tw .. hi * tw`` of dp row ``row``'s shards (row-major from
    the bottom GL row of its piece), folded into slice ``owner`` with their
    top row at row ``row0`` of the slice."""

    row: int
    lo: int
    hi: int
    owner: int
    row0: int


def plan_step(config: RenderConfig, dp: int, tile_x: int, tile_y: int):
    """How a step of tile (tile_x, tile_y) is split over dp rows: returns
    ``(starts, parts)``.

    The band's ``tile_h`` rows fall into dp pieces of ``tile_h / dp`` rows.
    Dp row i renders the i-th piece from the top, from GL row ``starts[i]``
    of the band, so that with the band the whole frame (``tile_size=1``)
    piece i is slice i.  The rows of a piece that the remainder band's
    mask leaves out (GL rows below ``dy0``) are neither copied nor folded;
    the rest is cut where it crosses a slice boundary into :class:`Part` s.
    A slice is at least as tall as a piece, so some piece lies wholly in
    its own dp row's slice: on distinct devices a step copies at most what
    it copied when ``accum`` lived on one device, every shard's colours
    but one piece's."""
    th = config.tile_h
    rows, slice_rows = th // dp, config.height // dp
    _, py0, _, dy0 = band_window(config, tile_x, tile_y)
    row0 = config.height - py0 - th  # the band's top image row
    starts, parts = [], []
    for i in range(dp):
        start = (dp - 1 - i) * rows
        starts.append(start)
        # image rows top .. end - 1 are the piece's GL rows rows - 1 down
        # to the lowest at or above dy0
        top = row0 + i * rows
        end = top + rows - min(max(dy0 - start, 0), rows)
        a = top
        while a < end:
            j = a // slice_rows
            b = min(end, (j + 1) * slice_rows)
            parts.append(Part(i, top + rows - b, top + rows - a, j,
                              a - j * slice_rows))
            a = b
    return starts, parts


def _send(cols, device):
    """``cols`` on ``device``, and the bytes that copied between devices."""
    if cols[0].device == device:
        return cols, 0
    return (tuple(c.to(device) for c in cols),
            sum(c.numel() * c.element_size() for c in cols))


# a mesh on distinct owner cards times each card's step every this many
# steps and issues the slowest card's shards first from then on
ORDER_EVERY = 64


def _slowest_first(clock) -> tuple:
    """The dp rows of a timed step's ``clock`` ((row, start event, end
    event) each) by their owner card's ms, the slowest first."""
    return tuple(i for i, _, _ in sorted(
        clock, key=lambda c: -c[1].elapsed_time(c[2])))


def _block_key(values: tuple) -> tuple:
    """What a shard block's words follow from besides its frame number and
    window: the camera's values (each vector's bytes), sky, jitter and
    ``lambertian``."""
    camera, sky, jitter, lambertian = values
    return (tuple(v.tobytes() for v in camera), float(sky), float(jitter),
            bool(lambertian))


class _Shard:
    """One (dp, sp) shard of a mesh: its device, its copy of the scene and
    its traversal, its step block, and the rows of the band it renders.
    On a card its body is captured once, into a memory pool shared with
    the other shards of its device, and replayed every step."""

    def __init__(self, scene, raycast_fn, config: RenderConfig,
                 traversal: str, rows: int, pool, index: int):
        self.scene, self.raycast_fn = scene, raycast_fn
        self.config, self.traversal, self.rows = config, traversal, rows
        self.index = index  # dp row * sp + sp index, in profiling's spans
        self.device = scene.device
        self.block = step_block.new(self.device)
        self.pool = pool
        self.graph = None
        # the inputs and stream of the words last written to the block,
        # and that stream (the next write on another stream waits for it)
        self._written = (None, None)

    def body(self):
        tw = self.config.tile_w
        return render_flat(self.scene, self.config, self.block,
                           tw * self.rows, tw, 1, self.raycast_fn,
                           self.traversal)

    def _stream_id(self):
        """The device's current stream as (stream id, device index, device
        type), or None on the CPU (``Renderer._stream_id``)."""
        return (torch._C._cuda_getCurrentStream(self.device.index)
                if self.device.type == "cuda" else None)

    def write(self, inputs: tuple, values: tuple) -> None:
        """Write the block of ``inputs`` = (frame number, window,
        :func:`_block_key` of ``values``): ``step_block.pack(frame,
        window, *values)``."""
        frame_count, window, _ = inputs
        step_block.write(self.block, step_block.pack(frame_count, window,
                                                     *values))
        self._written = ((inputs, self._stream_id()),
                         torch.cuda.current_stream(self.device)
                         if self.device.type == "cuda" else None)

    def run(self, inputs: tuple, values: tuple, eager: bool = False):
        """Render the shard's rows at ``inputs`` (:meth:`write`) -> 3
        color columns (in the graph's pool when replayed: read them before
        the next replay).  The block is written first unless it holds
        these inputs' words already, written ahead on this stream
        (counters ``step.block_ahead_hits`` / ``_misses``, one a shard)."""
        graphed = self.device.type == "cuda" and not eager
        if graphed and self.graph is None:
            with profiling.Span("step.capture", {"shard": self.index}):
                self.graph = step_graph.capture(self.body, self.device,
                                                pool=self.pool)
        with profiling.per_step("step.block", shard=self.index):
            stream = self._stream_id()
            written, written_on = self._written
            if written == (inputs, stream):
                profiling.count("step.block_ahead_hits")
            else:
                profiling.count("step.block_ahead_misses")
                if written is not None and written[1] != stream:
                    # the last write went to another stream: it runs first
                    torch.cuda.current_stream(self.device).wait_stream(
                        written_on)
                self.write(inputs, values)
        if graphed:
            with profiling.per_step("step.replay", shard=self.index):
                return self.graph.replay()
        with profiling.per_step("step.body", shard=self.index):
            return self.body()


def sharded_tile_step(shards, blocks, accum: RowShardedAccum, plan,
                      state: RenderState, camera: Camera, sky_brightness,
                      jitter_amount, lambertian, *, config: RenderConfig,
                      mesh: Mesh, eager: bool = False, order=None,
                      clock: list | None = None) -> int:
    """One mesh step: render one tile band, rows split over ``dp`` and
    frame numbers over ``sp``, and fold it into ``accum``'s slices in
    place.  Returns the bytes it copied between distinct devices.

    ``shards`` is the (dp, sp) grid of :class:`_Shard` and ``blocks`` the
    slices' step blocks; ``plan`` is :func:`plan_step`'s for the state's
    tile.  Shard (i, s) renders its piece at frame number
    ``frame_count + s``, each value in its own step block.  Dp row i sums
    its shards' colours on its sp=0 device in sp index order (out of
    place: a graph's outputs stay as its replay left them), and each part
    folds on its owner (G6, weight sp) at its window in the slice: the
    band's columns and their remainder mask are ``_tile_step``'s
    (``renderer.band_window``), so the image equals the sequential
    renderer's.

    The dp rows' shards are issued in ``order`` (default: top to
    bottom); ``clock``, where given, gains (row, start, end) timing events
    of each row's owner card, from before its shards to after its folds.

    Per-step spans (while tracing): ``mesh.fold`` around the sums, copies
    and folds (``args`` ``order``), and on cards one ``mesh.card`` device
    span an owner card, from before its shard's first launch to after its
    folds.  The counter ``mesh.bytes_moved`` gains the returned bytes."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    tw, rows = config.tile_w, config.tile_h // dp
    starts, parts = plan
    col0, py0, dx0, _ = band_window(config, state.tile_x, state.tile_y)
    values = (camera, sky_brightness, jitter_amount, lambertian)
    key = _block_key(values)
    order = tuple(range(dp)) if order is None else order
    marks = {} if profiling.tracing() else None
    colors = [None] * dp
    for i in order:
        owner = mesh.devices[i, 0]
        if marks is not None:  # owner card i's time, from its first launch
            marks[i] = profiling.device_mark(owner)
        if clock is not None:
            clock.append((i, profiling.timing_event(owner)))
        window = (col0, py0 + starts[i], 0, 0, 0)
        colors[i] = [shards[i][s].run((state.frame_count + s, window, key),
                                      values, eager) for s in range(sp)]
    moved, sums = 0, {}
    with profiling.per_step("mesh.fold", order=order):
        for i in sorted({p.row for p in parts}):
            lo = min(p.lo for p in parts if p.row == i)
            total = None
            for s in range(sp):
                cols, n = _send(tuple(c[lo * tw:rows * tw]
                                      for c in colors[i][s]),
                                mesh.devices[i, 0])
                moved += n
                total = cols if total is None else tuple(
                    a + b for a, b in zip(total, cols))
            sums[i] = lo, total
        for p in parts:
            lo, total = sums[p.row]
            cols, n = _send(tuple(c[(p.lo - lo) * tw:(p.hi - lo) * tw]
                                  for c in total), mesh.devices[p.owner, 0])
            moved += n
            target, block = accum.slices[p.owner], blocks[p.owner]
            th = p.hi - p.lo
            words = step_block.pack(
                state.frame_count, (col0, py0 + starts[p.row] + p.lo, dx0, 0,
                                    p.row0), *values, target.data_ptr())
            check_target(target, words, tw, th)
            step_block.write(block, words)
            fold_band(target, cols, block, tw, th, 1, sp)
    for i, start in (marks or {}).items():  # ... to after its folds
        profiling.device_span("mesh.card", start, card=i)
    if clock is not None:
        clock[:] = [(i, start, profiling.timing_event(mesh.devices[i, 0]))
                    for i, start in clock]
    profiling.count("mesh.bytes_moved", moved)
    return moved


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
    converges ``sp`` frames.  A state's ``accum`` is a
    :class:`RowShardedAccum` over ``owners`` (``devices[:, 0]``), updated
    in place by every step; ``RenderState`` round-trips through
    ``utils.checkpoint``, and :meth:`restore_state` scatters a loaded
    state's ``accum`` into new slices.  ``moved_bytes`` counts the bytes
    the steps copied between distinct devices."""

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
        self.owners = list(mesh.devices[:, 0])
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
        sp = mesh.shape["sp"]
        self._shards = [[_Shard(self.scenes[dev], raycasts[dev], config,
                                self.traversal, config.tile_h // dp,
                                pools[dev], i * sp + s)
                         for s, dev in enumerate(row)]
                        for i, row in enumerate(mesh.devices)]
        self._blocks = [step_block.new(dev) for dev in self.owners]
        self._plans = {}
        self.frames_per_step = sp
        self.moved_bytes = 0
        self._steps = 0  # the step sequence number of profiling's spans
        # the dp rows in the order their shards are issued.  A frame ends
        # when its slowest card does, and the host issues card after card,
        # so on distinct owner cards the slowest card goes first, timed by
        # events every ORDER_EVERY steps (the first timed step is the
        # second, after the capture); the others absorb the issue's delay
        self._order = tuple(range(dp))
        self._timed = (self.home.type == "cuda"
                       and len(set(self.owners)) == dp > 1)
        self._clock = None  # a timed step's events until they are read

    def init_state(self) -> RenderState:
        return RenderState(accum=RowShardedAccum.zeros(
            self.owners, self.config.height, self.config.width))

    def restore_state(self, state: RenderState) -> RenderState:
        """A copy of a (checkpoint-loaded) state with its ``accum`` in new
        slices on the owners, ready to step."""
        accum = state.accum
        if isinstance(accum, RowShardedAccum):
            accum = accum.cpu()
        return RenderState(
            accum=RowShardedAccum.scatter(accum, self.owners),
            frame_count=state.frame_count, tile_x=state.tile_x,
            tile_y=state.tile_y, total_frames=state.total_frames)

    def reset(self, state: RenderState) -> RenderState:
        """Zeroed counters and NEW zeroed slices (a copy of the old ones
        that a caller holds is left as it was)."""
        return self.init_state()

    def step(self, state: RenderState, camera: Camera,
             sky_brightness: float | None = None,
             jitter_amount: float | None = None,
             lambertian: bool | None = None) -> RenderState:
        """One tile band across the mesh + tile cursor advance;
        ``state.accum`` is updated in place and carried into the result.
        On cards each shard is one graph replay (captured at its first
        step), its block written ahead by the step before where that
        step's :func:`advance`, camera and settings are this one's, else
        written first; the sums, copies and folds run on the dp rows' and
        the owners' devices."""
        return self._step(state, camera, sky_brightness, jitter_amount,
                          lambertian, eager=False)

    def _step_eager(self, state: RenderState, camera: Camera,
                    sky_brightness=None, jitter_amount=None,
                    lambertian=None) -> RenderState:
        """:meth:`step` with every shard's body run eagerly: the yardstick
        the replays are held to (chip_smoke.py, the CUDA tests)."""
        return self._step(state, camera, sky_brightness, jitter_amount,
                          lambertian, eager=True)

    def _check_accum(self, accum) -> None:
        """A step folds into each slice in place, on a card by its address:
        slice j must be a contiguous (H/dp, W, 3) float32 tensor on
        ``owners[j]``."""
        cfg = self.config
        shape = (cfg.height // len(self.owners), cfg.width, 3)
        ok = (isinstance(accum, RowShardedAccum)
              and len(accum.slices) == len(self.owners)
              and all(s.device == dev and s.dtype == torch.float32
                      and tuple(s.shape) == shape and s.is_contiguous()
                      for s, dev in zip(accum.slices, self.owners)))
        if not ok:
            raise ValueError(
                f"accum must be a RowShardedAccum of contiguous {shape} "
                f"float32 slices on {[str(d) for d in self.owners]} "
                f"(restore_state places a loaded state)")

    def _step(self, state, camera, sky_brightness, jitter_amount,
              lambertian, eager: bool) -> RenderState:
        cfg = self.config
        self._steps += 1
        profiling.set_step(self._steps)
        self._check_accum(state.accum)
        values = (
            camera,
            cfg.sky_brightness if sky_brightness is None else sky_brightness,
            cfg.jitter_amount if jitter_amount is None else jitter_amount,
            cfg.lambertian if lambertian is None else lambertian)
        clock = ([] if self._timed and self._steps % ORDER_EVERY == 2
                 else None)
        self.moved_bytes += sharded_tile_step(
            self._shards, self._blocks, state.accum, self._plan(state),
            state, *values, config=cfg, mesh=self.mesh, eager=eager,
            order=self._order, clock=clock)
        nxt = advance(cfg, state, self.frames_per_step)
        self._write_ahead(nxt, values)
        self._read_clock(clock)
        return nxt

    def _plan(self, state: RenderState):
        """:func:`plan_step` of the state's tile, made once a tile."""
        tile = (state.tile_x, state.tile_y)
        if tile not in self._plans:
            self._plans[tile] = plan_step(self.config, len(self.owners),
                                          *tile)
        return self._plans[tile]

    def _read_clock(self, clock) -> None:
        """Order the dp rows by the last timed step's card ms once its
        events have completed (read without a wait, after this step's
        work is issued); keep ``clock``, this step's, for later."""
        done = self._clock
        if done is not None and all(end.query() for _, _, end in done):
            self._order = _slowest_first(done)
            self._clock = None
        if clock is not None:
            self._clock = clock

    def _write_ahead(self, state: RenderState, values: tuple) -> None:
        """Each shard's block of the step ``state`` begins, with this
        step's camera and settings, written behind this step's work while
        the cards render: the next step's shards replay at once where its
        inputs are these, so the host issues card after card faster."""
        starts = self._plan(state)[0]
        col0, py0, _, _ = band_window(self.config, state.tile_x,
                                      state.tile_y)
        key = _block_key(values)
        for i, row in enumerate(self._shards):
            window = (col0, py0 + starts[i], 0, 0, 0)
            for s, shard in enumerate(row):
                shard.write((state.frame_count + s, window, key), values)

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
        first: the slices gathered."""
        return state.accum.cpu().numpy()
