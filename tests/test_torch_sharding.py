"""The port's multi-device rendering (``opengl_raytracer_torch/parallel``)
on meshes of the CPU repeated, against the JAX ``ShardedRenderer`` on its
virtual CPU devices (tests/conftest.py) and against the port's sequential
``Renderer``; and the device guard of the kernel wrappers.

Tolerances: rmse <= 1e-6, as tests/test_sharding.py holds the JAX mesh to
its sequential renderer.  sp shards render frame numbers whose RNG
streams depend only on (x, y, frameNumber), and per-ray results do not
depend on which shard holds the ray, so the images differ only by the
order of the running mean's float additions.  A checkpoint resume is
bit-identical.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from opengl_raytracer_tpu.models.rect import Rect as JRect
from opengl_raytracer_tpu.models.scene import Scene as JScene
from opengl_raytracer_tpu.ops.camera import make_camera as j_make_camera
from opengl_raytracer_tpu.parallel.sharding import ShardedRenderer as JSharded
from opengl_raytracer_tpu.parallel.sharding import make_mesh as j_make_mesh
from opengl_raytracer_tpu.utils.checkpoint import load_checkpoint as j_load
from opengl_raytracer_tpu.utils.checkpoint import save_checkpoint as j_save
from opengl_raytracer_tpu.utils.config import RenderConfig as JRenderConfig

from opengl_raytracer_torch import Rect, RenderConfig, Renderer, Scene
from opengl_raytracer_torch import make_camera
from opengl_raytracer_torch.ops import (_kernels, fold, front, intersect,
                                        morton, permute, radix_sort, shade,
                                        step_block, traversal)
from opengl_raytracer_torch.ops import pallas_traversal as wide
from opengl_raytracer_torch.ops import subblock_traversal as sbt
from opengl_raytracer_torch.ops.intersect import BIG, Nearest
from opengl_raytracer_torch.parallel import (Mesh, RowShardedAccum,
                                             ShardedRenderer, make_mesh)
from opengl_raytracer_torch.parallel.sharding import plan_step
from opengl_raytracer_torch.renderer import RenderState, band_window
from opengl_raytracer_torch.utils.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
from opengl_raytracer_torch.utils.image import rmse
from test_torch_scene import jax_native  # noqa: F401 (autouse)

CAM = ([0.0, 0.0, 4.0], [180.0, 0.0])


def small_scene(rect_cls=Rect, scene_cls=Scene):
    """The three-Rect scene of tests/test_sharding.py:19-25."""
    return scene_cls([
        rect_cls([4, 4, 0.1], [0, 0, -2], [0, 0, 0], color=[0.8, 0.2, 0.2],
                 roughness=1),
        rect_cls([4, 4, 0.1], [0, 2, 0], [90, 0, 0], color=[0, 0, 0],
                 emission_color=[1, 1, 1], emission=1.0, roughness=1),
        rect_cls([4, 4, 0.1], [0, -2, 0], [90, 0, 0], color=[0.7, 0.7, 0.7],
                 roughness=1),
    ])


@pytest.fixture(scope="module")
def scene():
    return small_scene()


def cpu_mesh(dp, sp):
    return make_mesh(devices=["cpu"] * (dp * sp), dp=dp, sp=sp)


def sharded(scene, dp, sp, frames, **cfg):
    sr = ShardedRenderer(scene, RenderConfig(**cfg), cpu_mesh(dp, sp))
    state = sr.render(make_camera(*CAM), frames=frames)
    assert state.frame_count == frames
    return sr, sr.image(state)


def sequential(scene, frames, **cfg):
    r = Renderer(scene, RenderConfig(**cfg), device="cpu")
    return r.image(r.render(make_camera(*CAM), frames=frames))


# ------------------------------------------------ against the JAX mesh

@pytest.mark.parametrize("dp,sp", [(2, 1), (1, 2), (2, 2)])
def test_sharded_matches_jax_sharded(scene, dp, sp):
    cfg = dict(width=16, height=16, bounces=2, traversal="bvh")
    jr = JSharded(small_scene(JRect, JScene), JRenderConfig(**cfg),
                  j_make_mesh(dp * sp, dp=dp, sp=sp))
    ref = jr.image(jr.render(camera=j_make_camera(*CAM), frames=2 * sp))
    sr, got = sharded(scene, dp, sp, 2 * sp, **cfg)
    assert sr.frames_per_step == jr.frames_per_step == sp
    assert np.isfinite(got).all() and got.mean() > 0.01
    assert rmse(ref, got) <= 1e-6


# ------------------------------------------ against the port's Renderer

@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2), (2, 4), (1, 1)])
def test_sharded_matches_sequential(scene, dp, sp):
    cfg = dict(width=16, height=16, bounces=2, traversal="bvh")
    _, got = sharded(scene, dp, sp, 2 * sp, **cfg)
    assert rmse(got, sequential(scene, 2 * sp, **cfg)) <= 1e-6


def test_sharded_pallas2_matches_sequential(scene):
    """The sub-block traversal (K1's plain version here) and K2 on every
    shard; one sweep of sp frames equals the sequential running mean."""
    cfg = dict(width=16, height=16, bounces=2, traversal="pallas2")
    sr, got = sharded(scene, 2, 2, 2, **cfg)
    assert sr.traversal == "pallas2"
    np.testing.assert_array_equal(got, sequential(scene, 2, **cfg))


def test_auto_resolves_as_the_ports_renderer(scene):
    """"auto" is the port's rule ("pallas2" with sub-block tables; brute
    force on this 36-triangle scene), not the JAX mesh's "packet"."""
    sr = ShardedRenderer(scene, RenderConfig(width=16, height=16),
                         cpu_mesh(2, 1))
    r = Renderer(scene, RenderConfig(width=16, height=16), device="cpu")
    assert sr.traversal == r.traversal == "brute"
    big = Scene([Rect([1, 1, 1], [3 * i, 0, 0], [0, 0, 0], [0.5, 0.5, 0.5])
                 for i in range(12)])  # 144 triangles
    assert ShardedRenderer(big, RenderConfig(width=16, height=16),
                           cpu_mesh(1, 2)).traversal == "pallas2"


@pytest.mark.parametrize("w,h,tile_size", [(16, 16, 2), (16, 20, 3)])
def test_sharded_tiles_match_sequential(scene, w, h, tile_size):
    """Band rows split over dp within a tile; (16, 20, 3) has tile_h = 6
    with a remainder band (20 = 3 * 6 + 2), so the clamp and mask of the
    remainder band run under sharding."""
    cfg = dict(width=w, height=h, bounces=2, traversal="bvh")
    _, got = sharded(scene, 2, 2, 2, tile_size=tile_size, **cfg)
    assert rmse(got, sequential(scene, 2, **cfg)) <= 1e-6


def test_sharded_odd_shard_matches_sequential(scene):
    """8 rows x 12 columns = 96 rays a shard, not a multiple of 128:
    render_flat pads each shard's chunk to whole packets."""
    cfg = dict(width=12, height=16, bounces=1, traversal="pallas2")
    sr, got = sharded(scene, 2, 1, 1, **cfg)
    assert sr.traversal == "pallas2"
    assert rmse(got, sequential(scene, 1, **cfg)) <= 1e-6


def test_scene_sent_once_per_distinct_device(scene):
    sr = ShardedRenderer(scene, RenderConfig(width=16, height=16),
                         cpu_mesh(2, 2))
    assert list(sr.scenes) == [torch.device("cpu")]
    data = scene.send("cpu")
    assert ShardedRenderer(data, RenderConfig(width=16, height=16),
                           cpu_mesh(1, 2)).scene is data
    with pytest.raises(ValueError, match="scene lives on cpu, mesh device "
                                         "meta"):
        ShardedRenderer(data, RenderConfig(width=16, height=16),
                        make_mesh(devices=["cpu", "meta"]))


def test_state_buffers_are_owned(scene):
    """``accum``'s slices change in place with every step: ``image`` and
    ``restore_state`` copy, ``reset`` allocates new slices."""
    sr = ShardedRenderer(scene, RenderConfig(width=16, height=16, bounces=1),
                         cpu_mesh(2, 2))
    state = sr.render(make_camera(*CAM), frames=2)
    img = sr.image(state)
    restored = sr.restore_state(state)
    pairs = list(zip(restored.accum.slices, state.accum.slices))
    assert len(pairs) == 2
    assert all(a.data_ptr() != b.data_ptr() for a, b in pairs)
    assert restored.frame_count == 2
    fresh = sr.reset(state)
    assert fresh.frame_count == 0
    assert not any(s.any() for s in fresh.accum.slices)
    assert not {s.data_ptr() for s in fresh.accum.slices} & {
        s.data_ptr() for s in state.accum.slices}
    sr.step(state, make_camera(*CAM))
    np.testing.assert_array_equal(sr.image(restored), img)
    assert not np.array_equal(sr.image(state), img)


# ----------------------------------------------- the row-sharded accum

MESH_SHAPES = [(2, 1), (1, 2), (2, 2), (4, 1), (8, 1)]


def _slices_hold(accum, mesh, frame):
    """``accum`` is dp contiguous float32 slices, slice j on
    ``mesh.devices[j, 0]`` holding rows j * H/dp .. of ``frame``."""
    dp = mesh.shape["dp"]
    rows = frame.shape[0] // dp
    assert isinstance(accum, RowShardedAccum) and len(accum.slices) == dp
    for j, s in enumerate(accum.slices):
        assert s.device == mesh.devices[j, 0] and s.dtype == torch.float32
        assert tuple(s.shape) == (rows,) + frame.shape[1:]
        assert s.is_contiguous()
        np.testing.assert_array_equal(s.numpy(),
                                      frame[j * rows:(j + 1) * rows])


@pytest.mark.parametrize("dp,sp", MESH_SHAPES)
def test_accum_slices_on_the_dp_rows(scene, dp, sp):
    """``init_state``, a step, ``reset`` and ``restore_state`` keep ``accum``
    as dp slices of (H/dp, W, 3), slice j on ``devices[j, 0]``, the JAX
    ``P("dp")``; ``image`` gathers them top row first."""
    mesh = cpu_mesh(dp, sp)
    sr = ShardedRenderer(scene, RenderConfig(width=12, height=16, bounces=1),
                         mesh)
    assert sr.owners == list(mesh.devices[:, 0])
    state = sr.init_state()
    _slices_hold(state.accum, mesh, np.zeros((16, 12, 3), np.float32))
    slices = state.accum.slices
    state = sr.step(state, make_camera(*CAM))
    assert state.accum.slices == slices  # folded in place
    img = sr.image(state)
    assert img.shape == (16, 12, 3) and img.mean() > 0.01
    _slices_hold(state.accum, mesh, img)
    _slices_hold(sr.restore_state(state).accum, mesh, img)
    _slices_hold(sr.reset(state).accum, mesh, np.zeros_like(img))


def test_slices_follow_their_devices():
    """Slice j is made on the j-th device given; a scatter copies."""
    devs = [torch.device("cpu"), torch.device("meta")] * 2
    acc = RowShardedAccum.zeros(devs, 8, 3)
    assert [s.device for s in acc.slices] == devs
    assert all(tuple(s.shape) == (2, 3, 3) for s in acc.slices)
    frame = torch.arange(72, dtype=torch.float32).reshape(8, 3, 3)
    acc = RowShardedAccum.scatter(frame, [torch.device("cpu")] * 4)
    assert torch.equal(acc.cpu(), frame)
    assert all(s.data_ptr() != frame.data_ptr() for s in acc.slices)
    frame.zero_()
    assert acc.cpu().sum() == 71 * 72 / 2


def test_step_refuses_an_accum_it_does_not_own(scene):
    sr = ShardedRenderer(scene, RenderConfig(width=12, height=16, bounces=1),
                         cpu_mesh(2, 1))
    full = torch.zeros((16, 12, 3))
    for accum in (full, RowShardedAccum([full[:8], full[8:].to("meta")]),
                  RowShardedAccum([full[:8].clone()] * 3),
                  RowShardedAccum([full[:8].double(), full[8:]]),
                  RowShardedAccum([full[:8, ::2], full[8:]]),
                  RowShardedAccum([torch.zeros((12, 8, 3)).transpose(0, 1),
                                   full[8:]])):
        with pytest.raises(ValueError, match="restore_state places"):
            sr.step(RenderState(accum=accum), make_camera(*CAM))


def test_fold_target_is_checked_on_the_host():
    """The block's address and window are held to the slice before a
    fold's block is written."""
    s = torch.zeros((4, 6, 3))
    cam = make_camera(*CAM)
    ok = step_block.pack(0, (2, 0, 0, 0, 1), cam, 1, 0, True, s.data_ptr())
    fold.check_target(s, ok, 4, 3)
    with pytest.raises(ValueError, match="not into accum"):
        fold.check_target(torch.zeros((4, 6, 3)), ok, 4, 3)
    with pytest.raises(ValueError, match="leaves accum"):
        fold.check_target(s, ok, 4, 4)
    with pytest.raises(ValueError, match="leaves accum"):
        fold.check_target(s, ok, 5, 3)


def _copied_bytes(parts, devices, tw):
    """The bytes a step of ``parts`` copies between distinct devices of the
    (dp, sp) grid ``devices``, as ``sharded_tile_step`` routes them: each
    part's rows from every sp shard of its dp row to the row's sp=0
    device, and their sum from there to the owner's."""
    n = 0
    for p in parts:
        src = devices[p.row, 0]
        copies = sum(d != src for d in devices[p.row, 1:])
        copies += devices[p.owner, 0] != src
        n += int(copies) * (p.hi - p.lo) * tw * 12
    return n


def _home_card_bytes(devices, rows, tw):
    """The bytes a step copied when ``accum`` lived on ``devices[0, 0]``:
    each shard's colours, ``rows`` band rows, to it."""
    home = devices[0, 0]
    return int(sum(d != home for d in devices.flat)) * rows * tw * 12


def _check_plan(cfg, dp, tx, ty, starts, parts):
    """Every band row the remainder mask keeps is folded exactly once, at
    its own image row, by the dp row that renders it; no other row."""
    tw, th, H = cfg.tile_w, cfg.tile_h, cfg.height
    rows, slice_rows = th // dp, H // dp
    col0, py0, dx0, dy0 = band_window(cfg, tx, ty)
    assert sorted(starts) == [k * rows for k in range(dp)]
    folded = []
    for p in parts:
        assert 0 <= p.lo < p.hi <= rows
        assert 0 <= p.row0 and p.row0 + p.hi - p.lo <= slice_rows
        for y in range(p.lo, p.hi):  # a GL row of dp row p.row's piece
            image_row = p.owner * slice_rows + p.row0 + (p.hi - 1 - y)
            band_row = starts[p.row] + y
            assert image_row == H - py0 - 1 - band_row
            folded.append(band_row)
    assert sorted(folded) == list(range(dy0, th))


@pytest.mark.parametrize("dp,sp", MESH_SHAPES)
def test_moved_bytes_within_the_home_card_rule(dp, sp):
    """Over every tile of frames whose heights dp divides, at tile sizes
    1, 2, 3 and 5 (remainder bands included): the plan folds each kept
    band row once, at its row; on distinct devices it copies at most what
    a step copied when ``accum`` lived on the first device, and with the
    band the whole frame only the sp copies: none on (2, 1) or (4, 1).  A
    mesh of one device copies nothing, as the renderer counts."""
    distinct = np.arange(dp * sp).reshape(dp, sp)
    one = np.zeros((dp, sp), int)
    cases = 0
    for height in range(dp, 49, dp):
        for tile_size in (1, 2, 3, 5):
            cfg = RenderConfig(width=10, height=height, tile_size=tile_size)
            if cfg.tile_h < 1 or cfg.tile_h % dp:
                continue
            rows = cfg.tile_h // dp
            for ty in range(cfg.num_tiles_y):
                for tx in range(cfg.num_tiles_x):
                    starts, parts = plan_step(cfg, dp, tx, ty)
                    _check_plan(cfg, dp, tx, ty, starts, parts)
                    moved = _copied_bytes(parts, distinct, cfg.tile_w)
                    assert moved <= _home_card_bytes(distinct, rows,
                                                     cfg.tile_w)
                    if tile_size == 1:
                        assert moved == (sp - 1) * height * cfg.tile_w * 12
                    assert _copied_bytes(parts, one, cfg.tile_w) == 0
                    cases += 1
    assert cases > 20


@pytest.mark.parametrize("dp,sp", [(2, 2), (4, 1)])
def test_bytes_moved_counter_follows_moved_bytes(scene, monkeypatch, dp, sp):
    """The counter ``mesh.bytes_moved`` gains what ``moved_bytes`` counts:
    nothing on one device, and where every send is priced as a copy
    between cards, each send's bytes."""
    from opengl_raytracer_torch.parallel import sharding
    from opengl_raytracer_torch.utils import profiling

    sr = ShardedRenderer(scene, RenderConfig(width=16, height=16, bounces=1,
                                             traversal="bvh"),
                         cpu_mesh(dp, sp))
    camera, state = make_camera(*CAM), sr.init_state()

    def counted():
        return profiling.counts().get("mesh.bytes_moved", 0)

    before = counted()
    state = sr.step(state, camera)
    assert counted() == before and sr.moved_bytes == 0
    plain = sharding._send
    monkeypatch.setattr(sharding, "_send", lambda cols, device: (
        plain(cols, device)[0],
        sum(c.numel() * c.element_size() for c in cols)))
    for _ in range(2):
        state = sr.step(state, camera)
    # each dp row's sp shards to its first device, then its piece to its
    # slice: (sp + 1) sends of the piece's colours a dp row
    assert sr.moved_bytes == 2 * (sp + 1) * 16 * 16 * 12
    assert counted() - before == sr.moved_bytes


def test_shard_blocks_are_written_ahead(scene):
    """Each step writes every shard's block of the step ``advance``
    predicts, with its camera and settings: a step that follows it with
    the same camera and settings writes none (a hit a shard), a moved
    camera or another sky writes each (a miss a shard), and the frames
    equal the sequential renderer's through the same script."""
    from opengl_raytracer_torch.utils import profiling

    cfg = RenderConfig(width=16, height=16, bounces=2, traversal="bvh",
                       tile_size=2)
    sr = ShardedRenderer(scene, cfg, cpu_mesh(2, 1))
    r = Renderer(scene, cfg, device="cpu")
    moved = make_camera([0.3, -0.2, 3.6], [176.0, 4.0])
    script = [(make_camera(*CAM), None)] * 5 + [(moved, None)] * 2 + [
        (moved, 0.5)]
    a, b, got = sr.init_state(), r.init_state(), []
    for camera, sky in script:
        before = profiling.counts()
        a = sr.step(a, camera, sky_brightness=sky)
        after = profiling.counts()
        b = r.step(b, camera, sky_brightness=sky)
        got.append(tuple(after.get(k, 0) - before.get(k, 0) for k in (
            "step.block_ahead_hits", "step.block_ahead_misses")))
    assert got == [(0, 2)] + [(2, 0)] * 4 + [(0, 2), (2, 0), (0, 2)]
    np.testing.assert_array_equal(sr.image(a), r.image(b))


def test_slowest_card_first():
    """The dp rows by their timed card ms, the slowest first, ties in the
    rows' order; a mesh on the CPU times nothing and keeps the order."""
    from opengl_raytracer_torch.parallel.sharding import _slowest_first

    class Event:
        def __init__(self, ms):
            self.ms = ms

        def elapsed_time(self, end):
            return end.ms - self.ms

    clock = [(i, Event(0.0), Event(ms))
             for i, ms in enumerate([2.5, 3.0, 2.5, 2.0])]
    assert _slowest_first(clock) == (1, 0, 2, 3)
    sr = ShardedRenderer(small_scene(), RenderConfig(width=8, height=8),
                         cpu_mesh(4, 1))
    assert not sr._timed and sr._order == (0, 1, 2, 3)


def test_mesh_issues_rows_in_the_timed_order(scene, monkeypatch):
    """Where a mesh times its cards (here with fake events, row i's owner
    taking i ms at the second step), the third step reads the events,
    after its own shards, and the rows are issued slowest first from the
    fourth, each row's shards spanned in that order; the image is the
    sequential renderer's."""
    from opengl_raytracer_torch.utils import profiling

    made = []

    class Event:
        def __init__(self):
            self.k = len(made) % 8  # a timed step: 4 starts, then 4 ends
            made.append(self)

        def query(self):
            return True

        def elapsed_time(self, end):
            return float(self.k)

    monkeypatch.setattr(profiling, "timing_event", lambda device: Event())
    cfg = dict(width=16, height=16, bounces=2, traversal="bvh")
    sr = ShardedRenderer(scene, RenderConfig(**cfg), cpu_mesh(4, 1))
    sr._timed = True
    camera, state = make_camera(*CAM), sr.init_state()
    profiling.clear()
    profiling.enable(True)
    try:
        for _ in range(4):
            state = sr.step(state, camera)
    finally:
        profiling.enable(False)
    assert len(made) == 8 and sr._order == (3, 2, 1, 0)
    shards = [(s.step, s.args["shard"]) for s in profiling.spans()
              if s.name == "step.body"]
    assert shards == [(k, i) for k in (1, 2, 3) for i in range(4)] + [
        (4, i) for i in (3, 2, 1, 0)]
    profiling.clear()
    np.testing.assert_array_equal(sr.image(state),
                                  sequential(scene, 4, **cfg))


@pytest.mark.parametrize("dp,w,h,tile_size", [
    (2, 16, 16, 1), (4, 16, 16, 1), (8, 16, 16, 1), (2, 16, 20, 3),
    (4, 15, 24, 3), (4, 10, 24, 5)])
def test_sp1_matches_sequential_bit_for_bit(scene, dp, w, h, tile_size):
    """With sp = 1 each pixel folds the same colour with the same
    arithmetic as the sequential renderer's: the images are equal.
    (2, 16, 20, 3) and (4, 10, 24, 5) have remainder bands, and the latter
    pieces of one row that land in slices of six."""
    cfg = dict(width=w, height=h, bounces=2, traversal="bvh",
               tile_size=tile_size)
    sr, got = sharded(scene, dp, 1, 2, **cfg)
    np.testing.assert_array_equal(got, sequential(scene, 2, **cfg))
    assert sr.moved_bytes == 0  # one device


# --------------------------------------------------------- checkpoints

@pytest.mark.parametrize("dp,sp", [(2, 1), (4, 1), (2, 2)])
def test_checkpoint_gathers_and_scatters_the_slices(scene, tmp_path, dp, sp):
    """A saved mesh state holds the gathered frame in the JAX package's
    format (its loader reads it back) and ``restore_state`` puts each
    slice's rows back on its owner."""
    cfg = RenderConfig(width=12, height=16, bounces=1, tile_size=2)
    mesh = cpu_mesh(dp, sp)
    sr = ShardedRenderer(scene, cfg, mesh)
    state = sr.step(sr.render(make_camera(*CAM), frames=sp),
                    make_camera(*CAM))
    img = sr.image(state)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state, cam_pos=CAM[0], cam_dir=CAM[1])
    jstate, jpos, _ = j_load(path)
    np.testing.assert_array_equal(np.asarray(jstate.accum), img)
    assert (jstate.frame_count, jstate.tile_x, jstate.total_frames) == (
        sp, 1, 5)
    np.testing.assert_array_equal(jpos, CAM[0])
    loaded = load_checkpoint(path, "cpu")[0]
    _slices_hold(sr.restore_state(loaded).accum, mesh, img)


def test_sharded_checkpoint_resume(scene, tmp_path):
    """A render interrupted half way and resumed from disk is
    bit-identical to an uninterrupted one."""
    cfg = RenderConfig(width=16, height=16, bounces=2, tile_size=2,
                       traversal="bvh")
    sr = ShardedRenderer(scene, cfg, cpu_mesh(2, 2))
    full = sr.image(sr.render(make_camera(*CAM), frames=4))

    half = sr.render(make_camera(*CAM), frames=2)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, half, cam_pos=CAM[0], cam_dir=CAM[1])
    loaded, cam_pos, cam_dir = load_checkpoint(path, "cpu")
    resumed = sr.restore_state(loaded)
    assert resumed.frame_count == 2
    resumed = sr.render(make_camera(cam_pos, cam_dir), frames=2,
                        state=resumed)
    np.testing.assert_array_equal(sr.image(resumed), full)


def test_port_resumes_a_jax_sharded_checkpoint(scene, tmp_path):
    """Two frames of the JAX mesh saved mid-render (a non-zero tile
    cursor), then resumed by the port's mesh to frame 4: equal to 4
    straight frames of the port's mesh."""
    kw = dict(width=16, height=16, bounces=2, tile_size=2, traversal="bvh")
    jr = JSharded(small_scene(JRect, JScene), JRenderConfig(**kw),
                  j_make_mesh(4, dp=2, sp=2))
    jcam = j_make_camera(*CAM)
    jstate = jr.render(camera=jcam, frames=2)
    jstate = jr.step(jstate, jcam)
    path = str(tmp_path / "j.npz")
    j_save(path, jstate, cam_pos=CAM[0], cam_dir=CAM[1])

    sr = ShardedRenderer(scene, RenderConfig(**kw), cpu_mesh(2, 2))
    loaded, cam_pos, cam_dir = load_checkpoint(path, "cpu")
    state = sr.restore_state(loaded)
    assert (state.frame_count, state.tile_x, state.tile_y,
            state.total_frames) == (2, 1, 0, 5)
    cam = make_camera(cam_pos, cam_dir)
    for _ in range(3):  # the rest of the sweep: frame 4
        state = sr.step(state, cam)
    assert (state.frame_count, state.tile_x, state.tile_y) == (4, 0, 0)
    straight = sr.image(sr.render(make_camera(*CAM), frames=4))
    assert rmse(sr.image(state), straight) <= 1e-6


# --------------------------------------------------------------- errors

def test_make_mesh_defaults_and_errors():
    assert make_mesh(devices=["cpu"] * 4).shape == {"dp": 2, "sp": 2}
    assert make_mesh(devices=["cpu"] * 3).shape == {"dp": 3, "sp": 1}
    assert make_mesh(devices=["cpu"]).shape == {"dp": 1, "sp": 1}
    mesh = make_mesh(2, devices=["cpu"] * 4)
    assert mesh.devices.size == 2 and isinstance(mesh, Mesh)
    with pytest.raises(ValueError, match="!="):
        make_mesh(4, dp=3, sp=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="!="):
        make_mesh(dp=2, devices=["cpu"] * 4)  # sp defaults to 1
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(sp=3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="only 2 available"):
        make_mesh(3, devices=["cpu"] * 2)


def test_make_mesh_refuses_more_cards_than_exist():
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"only {n} available on platform "
                                         f"cuda"):
        make_mesh(n + 1)


@pytest.mark.parametrize("cfg,dp,match", [
    (dict(width=16, height=15), 2, "must divide height"),
    (dict(width=16, height=16, tile_size=3), 2, "tile band height"),
    (dict(width=16, height=16, frames_per_step=2), 1, "frames_per_step"),
])
def test_constructor_errors(scene, cfg, dp, match):
    with pytest.raises(ValueError, match=match):
        ShardedRenderer(scene, RenderConfig(**cfg), cpu_mesh(dp, 1))


def test_render_refuses_frames_not_a_multiple_of_sp(scene):
    sr = ShardedRenderer(scene, RenderConfig(width=16, height=16),
                         cpu_mesh(1, 2))
    with pytest.raises(ValueError, match="multiple of sp=2"):
        sr.render(make_camera(*CAM), frames=3)


# --------------------------------------------------------- device guard

@pytest.fixture
def fake_card(monkeypatch):
    """The card's runtime as far as a launch sees it: ``torch.cuda.device``
    (the guard) sets the device ``torch.cuda.current_device`` reports,
    and the kernel library records that device at every call."""
    current = ["outside the guard"]
    calls = []

    @contextlib.contextmanager
    def guard(device):
        prev, current[0] = current[0], torch.device(device)
        try:
            yield
        finally:
            current[0] = prev

    class Lib:
        def __getattr__(self, symbol):
            def kernel(*args):
                calls.append((symbol, torch.cuda.current_device()))
                return 0
            return kernel

    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(_kernels, "lib", Lib)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda device: 0)
    return calls


def _launch(kernel, device, odd_one=None):
    """Call ``kernel``'s CUDA wrapper with every tensor on ``device`` but
    ``odd_one``'s, which lies on the meta device."""
    R = 256

    def t(name, shape, dtype=torch.float32):
        dev = "meta" if name == odd_one else device
        return torch.zeros(shape, dtype=dtype, device=dev)

    o3 = tuple(t(f"o{a}", R) for a in "xyz")
    d3 = tuple(t(f"d{a}", R) for a in "xyz")
    i64, i32 = torch.int64, torch.int32
    block = t("block", step_block.WORDS, i32)
    if kernel == "ray_front":
        return front._ray_front_cuda(block, 0, R, R, R, 16, 16, 16, None)
    if kernel == "step_block":
        return step_block._write_cuda(block, np.zeros(step_block.WORDS,
                                                      np.int32))
    if kernel == "band_fold":
        colors = (t("c0", R), t("c1", R), t("c2", R))
        return fold._fold_cuda(t("accum", (16, 16, 3)), colors, block, 16,
                               16, 1, 1)
    if kernel == "wide_prologue":
        return wide._prologue_cuda(t("active", R, torch.bool), R,
                                   torch.device(device))
    if kernel == "wide_epilogue":
        return wide._epilogue_cuda(t("t", R), t("slot", R, i32), t("u", R),
                                   t("v", R), t("remap", 8, i32))
    if kernel == "sort_keys":
        return morton._sort_keys_cuda(o3, d3, np.zeros(3, np.float32),
                                      np.ones(3, np.float32),
                                      t("alive", R, torch.bool))
    if kernel == "radix_sort":
        return radix_sort._sort_cuda(t("keys", R, i32))
    if kernel == "reorder":
        return permute._reorder_cuda(t("keys", R, i32), t("perm", R, i32),
                                     o3, d3, o3, d3, t("seed", R, i64),
                                     t("orig", R, i32), False)
    if kernel == "restore":
        return permute._restore_cuda(d3, t("seed", R, i64), t("orig", R, i32))
    if kernel == "shade":
        near = Nearest(t=t("t", R), tri=t("tri", R, torch.int32),
                       u=t("u", R), v=t("v", R))
        return shade._shade_cuda(
            t("table", (4, 24)), t("index", R, torch.int32), near, o3, d3,
            o3, d3, t("alive", R, torch.bool), t("seed", R, torch.int64),
            block)
    if kernel in ("brute_sweep", "bvh_walk", "packet_walk"):
        # the scene's records, as the upload packs them
        scene = types.SimpleNamespace(
            num_tris=8, tri_records=t("tris", (8, 12)),
            node_records=t("nodes", (3, 8), torch.int32))
        if kernel == "brute_sweep":
            return intersect._sweep_cuda(scene, o3, d3)
        if kernel == "packet_walk":
            return traversal._packet_cuda(scene, o3, d3, None, 4)
        return traversal._walk_cuda(scene, o3, d3, None, 4)
    t0 = t("t0", R).fill_(BIG)
    overflow = t("overflow", 1, torch.int32)
    if kernel in ("subblock_traversal", "subblock_parts"):
        parts = ((t("node_rows", (2, 64), torch.int32), t("tri_rows", (2, 96)),
                  t("remap", 16, i32)),)
        if kernel == "subblock_parts":
            parts *= 2
        return sbt._chain_cuda(parts, o3, d3, t0, overflow)
    return wide._traverse_cuda(t("pw_tiles", (2, 64), torch.int32),
                               t("pl_tri_tiles", (2, 96)), o3, d3, t0, 16,
                               overflow)


# "subblock_traversal" is K1's chain of one part, "subblock_parts" of two
KERNEL_SYMBOLS = {"subblock_traversal": "oglrt_subblock_traverse_parts",
                  "subblock_parts": "oglrt_subblock_traverse_parts",
                  "shade": "oglrt_shade",
                  "wide_traversal": "oglrt_wide_traverse",
                  "ray_front": "oglrt_ray_front",
                  "sort_keys": "oglrt_sort_keys",
                  "radix_sort": "oglrt_radix_sort",
                  "reorder": "oglrt_reorder",
                  "restore": "oglrt_restore",
                  "wide_prologue": "oglrt_wide_prologue",
                  "wide_epilogue": "oglrt_wide_epilogue",
                  "band_fold": "oglrt_band_fold",
                  "step_block": "oglrt_write_block",
                  "brute_sweep": "oglrt_brute_sweep",
                  "bvh_walk": "oglrt_bvh_walk",
                  "packet_walk": "oglrt_packet_walk"}
# kernels a call of the symbol launches, where it is not one: the reorder's
# index pass and gather, the sort's histogram launch and four passes
KERNELS_A_CALL = {"reorder": 2, "radix_sort": 5}
# the counter of a symbol named otherwise: G5's two entry points share one,
# and K1's chains of one part and of two count their launches in one
COUNTER = {"wide_prologue": "wide_epilogue",
           "subblock_parts": "subblock_traversal"}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("kernel", sorted(KERNEL_SYMBOLS))
def test_wrapper_launches_on_its_tensors_device(fake_card, kernel, device):
    before = dict(_kernels.launch_counts)
    _launch(kernel, device)
    assert fake_card == [(KERNEL_SYMBOLS[kernel], torch.device(device))]
    counter = COUNTER.get(kernel, kernel)
    assert (_kernels.launch_counts[counter]
            == before[counter] + KERNELS_A_CALL.get(kernel, 1))
    walked = {"subblock_traversal": 1, "subblock_parts": 2}.get(kernel, 0)
    assert _kernels.launch_counts["subblock_parts"] == (
        before["subblock_parts"] + walked)
    assert torch.cuda.current_device() == "outside the guard"


def test_radix_sort_of_no_keys_launches_nothing(fake_card):
    """G10 on no keys hands back two empty int32 tensors on the keys'
    device and neither launches nor counts a kernel."""
    before = dict(_kernels.launch_counts)
    keys_s, perm = radix_sort._sort_cuda(torch.zeros(0, dtype=torch.int32))
    assert keys_s.dtype == perm.dtype == torch.int32
    assert keys_s.numel() == perm.numel() == 0
    assert fake_card == [] and _kernels.launch_counts == before


@pytest.mark.parametrize("kernel,odd_one", [
    ("subblock_traversal", "node_rows"), ("subblock_traversal", "dz"),
    ("shade", "alive"), ("shade", "table"), ("shade", "block"),
    ("wide_traversal", "oy"), ("wide_traversal", "pl_tri_tiles"),
    ("sort_keys", "dz"),
    ("sort_keys", "alive"), ("reorder", "perm"), ("reorder", "oz"),
    ("restore", "seed"), ("subblock_parts", "remap"),
    ("subblock_parts", "node_rows"), ("subblock_parts", "dz"),
    ("wide_prologue", "active"), ("wide_epilogue", "slot"),
    ("wide_epilogue", "remap"), ("band_fold", "accum"),
    ("band_fold", "c1"), ("brute_sweep", "tris"), ("bvh_walk", "nodes"),
    ("bvh_walk", "tris"), ("packet_walk", "nodes"), ("packet_walk", "oz")])
def test_wrapper_refuses_tensors_on_two_devices(fake_card, kernel, odd_one):
    """Each wrapper takes its device from one tensor (``t0``, ``seed``,
    ``ox``, ``keys``, ``orig``, K1's or K3's ``t``, or the step block) or
    its device argument and refuses any other tensor that lies elsewhere,
    before launching.  G1 and the block's write take no other tensor."""
    before = dict(_kernels.launch_counts)
    with pytest.raises(ValueError, match="is on meta, expected cpu"):
        _launch(kernel, "cpu", odd_one)
    assert fake_card == [] and _kernels.launch_counts == before


def test_cached_build_keeps_its_nvcc_log(tmp_path, monkeypatch):
    """A library built earlier comes with the nvcc output of its own build
    (ptxas' registers and spills), kept beside it, so a second run in the
    same checkout still reports them."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != -o ]; do shift; done\n'
                    'echo "ptxas info    : Used 42 registers"\n: > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    lib = tmp_path / "build" / "lib.so"
    monkeypatch.setattr(_kernels, "LIB_PATH", str(lib))
    monkeypatch.setattr(_kernels, "build_log", "")
    assert _kernels.build() == str(lib)
    first = _kernels.build_log
    assert "== subblock_traversal.cu" in first and "Used 42 registers" in first
    _kernels.build_log = ""
    assert _kernels.build() == str(lib)  # newer than every source: no nvcc
    assert _kernels.build_log == first
