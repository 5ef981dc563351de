"""The port's entry points on the CPU: ``Renderer.reset`` and the default
camera, checkpoints, ``App`` (headless and interactive), the CLI, the PNG
codec and the profiling helpers, against the JAX package where it has the
same function.

Tolerances: the port against itself (resume, tiles, the default camera)
is exact or rmse < 1e-7, as tests/test_app.py asks of the JAX package;
the port against the JAX package rmse < 1e-4, as tests/test_torch_render.py
allows (XLA contracts mul+add into FMAs, eager torch does not).
"""

import argparse
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from opengl_raytracer_tpu.__main__ import build_parser as j_build_parser
from opengl_raytracer_tpu.__main__ import main as j_main
from opengl_raytracer_tpu.app import App as JApp
from opengl_raytracer_tpu.models.rect import Rect as JRect
from opengl_raytracer_tpu.models.scene import Scene as JScene
from opengl_raytracer_tpu.utils.checkpoint import load_checkpoint as j_load
from opengl_raytracer_tpu.utils.checkpoint import save_checkpoint as j_save
from opengl_raytracer_tpu.utils.profiling import FrameStats as JFrameStats

from opengl_raytracer_torch import (Rect, RenderConfig, Renderer, Scene,
                                    make_camera)
from opengl_raytracer_torch.__main__ import build_parser, main
from opengl_raytracer_torch.app import App
from opengl_raytracer_torch.presets import DEFAULT_CAM_DIR, DEFAULT_CAM_POS
from opengl_raytracer_torch.utils import profiling
from opengl_raytracer_torch.utils.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
from opengl_raytracer_torch.utils.image import (load_png, rmse, save_png,
                                                to_uint8)
from opengl_raytracer_torch.utils.profiling import FrameStats, trace
from test_torch_obj import write_latlong_obj
from test_torch_scene import jax_native  # noqa: F401 (autouse)

CKPT_KEYS = ("accum", "frame_count", "tile_x", "tile_y", "total_frames",
             "cam_pos", "cam_dir", "has_camera")


def tiny_scene(rect_cls=Rect, scene_cls=Scene):
    """The two-Rect scene of tests/test_app.py:12-17 (brute force in both
    packages)."""
    return scene_cls([
        rect_cls([4, 4, 0.1], [0, 0, -2], [0, 0, 0], color=[0.8, 0.2, 0.2],
                 roughness=1),
        rect_cls([2, 2, 0.1], [0, 1.9, 0], [90, 0, 0], color=[0, 0, 0],
                 emission_color=[1, 1, 1], emission=1.0, roughness=1),
    ])


CAM = ((0.0, 0.0, 4.0), (180.0, 0.0))  # facing the lit back wall


def _start(a, run):
    a.camPos, a.camDir = (np.array(c, np.float32) for c in CAM)
    a.camera = a._make_camera()
    if run:
        a.main()
    return a


def japp(tmp_path, name, run=True, **kw):
    """A headless JAX App on the tiny scene, seen from CAM."""
    kw = dict(dict(window_size=(16, 16), bounces=1, headless=True,
                   max_frames=2), **kw)
    return _start(JApp(scene=tiny_scene(JRect, JScene), run=False,
                       output=str(tmp_path / f"{name}.png"), **kw), run)


def app(tmp_path, name, run=True, **kw):
    """The port's App on the CPU, as japp."""
    kw = dict(dict(window_size=(16, 16), bounces=1, headless=True,
                   max_frames=2), **kw)
    return _start(App(scene=tiny_scene(), run=False, device="cpu",
                      output=str(tmp_path / f"{name}.png"), **kw), run)


# ------------------------------------------------------------ renderer

def test_reset_zeroes_state_and_leaves_held_copies():
    r = Renderer(tiny_scene(), RenderConfig(width=16, height=16, bounces=1,
                                            tile_size=2), device="cpu")
    state = r.render(frames=1)
    state = r.step(state, make_camera(DEFAULT_CAM_POS, DEFAULT_CAM_DIR))
    held, view = state.accum.clone(), state.accum
    assert state.frame_count == 1 and state.tile_x == 1
    assert float(held.abs().max()) > 0  # the sky at least
    fresh = r.reset(state)
    assert (fresh.frame_count, fresh.tile_x, fresh.tile_y,
            fresh.total_frames) == (0, 0, 0, 0)
    assert fresh.accum.shape == held.shape and not fresh.accum.any()
    assert fresh.accum.data_ptr() != view.data_ptr()
    assert torch.equal(view, held)  # the old buffer is not zeroed


def test_render_without_camera_uses_the_preset_pose():
    r = Renderer(tiny_scene(), RenderConfig(width=16, height=12, bounces=1),
                 device="cpu")
    default = r.image(r.render(frames=2))
    named = r.image(r.render(make_camera(DEFAULT_CAM_POS, DEFAULT_CAM_DIR),
                             frames=2))
    np.testing.assert_array_equal(default, named)
    pose = ([0.5, 0.2, 3.0], (180.0, 0.0))
    np.testing.assert_array_equal(
        r.image(r.render(cam_pos=pose[0], cam_dir=pose[1])),
        r.image(r.render(make_camera(*pose))))


# ---------------------------------------------------------- checkpoints

def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_checkpoints_cross_between_packages(tmp_path):
    """Saved by the JAX package and loaded by the port, then saved by the
    port and loaded by the JAX package: every key equal."""
    ja = japp(tmp_path, "j", tileSize=3, max_frames=1, run=False)
    for _ in range(5):  # mid-sweep: a non-zero tile cursor
        ja.state = ja.renderer.step(ja.state, ja.camera)
    j_path, t_path = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_save(j_path, ja.state, ja.camPos, ja.camDir)

    state, cp, cd = load_checkpoint(j_path, "cpu")
    assert (state.frame_count, state.tile_x, state.tile_y,
            state.total_frames) == (0, 1, 1, 5)  # 4x4 tiles a sweep
    save_checkpoint(t_path, state, cp, cd)
    ref, got = _npz(j_path), _npz(t_path)
    assert sorted(ref) == sorted(got) == sorted(CKPT_KEYS)
    for k in CKPT_KEYS:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)

    jstate, jcp, jcd = j_load(t_path)
    np.testing.assert_array_equal(np.asarray(jstate.accum), ref["accum"])
    assert (jstate.frame_count, jstate.tile_x, jstate.tile_y,
            jstate.total_frames) == (0, 1, 1, 5)
    np.testing.assert_array_equal(jcp, ja.camPos)
    np.testing.assert_array_equal(jcd, ja.camDir)

    save_checkpoint(t_path, state)  # no camera
    assert load_checkpoint(t_path, "cpu")[1:] == (None, None)


def _resume(make, tmp_path, path, load):
    """2 frames from a checkpoint at ``path``, through ``make``'s App."""
    c = make(tmp_path, "resumed", run=False)
    state, cp, cd = load(path)
    assert state.frame_count == 2
    c.state = state
    c.camPos, c.camDir = cp.astype(np.float32), cd.astype(np.float32)
    c.camera = c._make_camera()
    c.main()
    assert c.state.frame_count == 4
    return c.image()


def test_resume_equals_straight_render(tmp_path):
    path = str(tmp_path / "ck.npz")
    straight = app(tmp_path, "a", max_frames=4)
    b = app(tmp_path, "b")
    save_checkpoint(path, b.state, b.camPos, b.camDir)
    resumed = _resume(app, tmp_path, path,
                      lambda p: load_checkpoint(p, "cpu"))
    assert rmse(straight.image(), resumed) < 1e-7


def test_port_resumes_a_jax_checkpoint(tmp_path):
    path = str(tmp_path / "ck.npz")
    b = japp(tmp_path, "b")
    j_save(path, b.state, b.camPos, b.camDir)
    ref = _resume(japp, tmp_path, path, j_load)
    got = _resume(app, tmp_path, path, lambda p: load_checkpoint(p, "cpu"))
    assert np.isfinite(got).all() and got.mean() > 0.01
    assert rmse(ref, got) < 1e-4


# ------------------------------------------------------------------ App

def test_headless_app_renders_and_saves(tmp_path):
    a = app(tmp_path, "out")
    assert a.state.frame_count == 2 and a.device == torch.device("cpu")
    img = load_png(str(tmp_path / "out.png"))
    assert img.shape == (16, 16, 3)
    np.testing.assert_array_equal(np.round(img * 255).astype(np.uint8),
                                  to_uint8(a.image()))


def test_headless_remainder_tiles_equal_untiled(tmp_path):
    tiled = app(tmp_path, "t", tileSize=3)
    assert tiled.renderer.config.num_tiles_x == 4  # ceil(16 / (16 // 3))
    assert tiled.state.frame_count == 2
    assert tiled.state.tile_x == 0 and tiled.state.tile_y == 0
    flat = app(tmp_path, "f")
    np.testing.assert_array_equal(tiled.image(), flat.image())


def test_reset_frames(tmp_path):
    a = app(tmp_path, "r", max_frames=1, run=False)
    a.state = a.renderer.step(a.state, a.camera)
    assert a.state.frame_count == 1 and a.image().max() > 0
    a.resetFrames()
    assert a.state.frame_count == 0 and a.state.total_frames == 0
    assert float(np.abs(a.image()).max()) == 0.0


def test_snapshot_survives_the_next_sweep(tmp_path):
    """The displayed frame, handed to the sink at a sweep's end, must not
    change while the next sweep updates ``accum`` in place."""
    a = app(tmp_path, "s", tileSize=2, run=False)
    shown = []

    def sink(image, frame_count):
        shown.append((image, frame_count))

    for _ in range(4):
        a.frame("", (0, 0), sink)
    assert a.state.tile_x == 0 and a.state.tile_y == 0 and not shown
    swept = to_uint8(a.image())
    a.frame("", (0, 0), sink)  # the next sweep's first step shows sweep 1
    (snap, frame), = shown
    kept = snap.clone()
    assert frame == 1
    np.testing.assert_array_equal(kept.numpy(), swept)
    for _ in range(3):
        a.frame("", (0, 0), sink)
    assert len(shown) == 1 and a.state.frame_count == 2
    assert not np.array_equal(to_uint8(a.image()), swept)  # accum changed
    assert torch.equal(snap, kept)


def _delta(before, name):
    return profiling.counts().get(name, 0) - before.get(name, 0)


def test_frame_resets_on_a_move_and_not_when_still(tmp_path):
    a = app(tmp_path, "m", run=False)
    a.canMove = True
    pos, yaw = a.camPos.copy(), a.camDir.copy()
    before = profiling.counts()
    for _ in range(3):
        a.frame("", (0, 0), lambda *_: None)
    assert a.state.frame_count == 3 and _delta(before, "app.resets") == 0
    a.frame("w", (0, 0), lambda *_: None)
    assert _delta(before, "app.resets") == 1 and a.state.frame_count == 1
    forward = a.get_camera_basis(yaw)[1]
    np.testing.assert_array_equal(a.camPos, pos + np.float32(1.0) * forward)
    a.frame("", (20, 0), lambda *_: None)  # 20 units of mouse: 2 degrees
    assert _delta(before, "app.resets") == 2 and a.state.frame_count == 1
    np.testing.assert_array_equal(a.camDir, yaw + np.float32([2.0, 0.0]))
    a.frame("", (0, 0), lambda *_: None)
    assert _delta(before, "app.resets") == 2 and a.state.frame_count == 2
    a.canMove = False  # the mouse is ignored, a fly key still resets
    a.frame("", (20, 5), lambda *_: None)
    assert _delta(before, "app.resets") == 2 and a.state.frame_count == 3
    dir_before, pos_before = a.camDir.copy(), a.camPos.copy()
    a.frame("s", (0, 0), lambda *_: None)
    assert _delta(before, "app.resets") == 3 and a.state.frame_count == 1
    np.testing.assert_array_equal(a.camDir, dir_before)
    np.testing.assert_array_equal(a.camPos, pos_before)
    assert _delta(before, "step.captures") == 0  # the CPU runs no graph


def test_frame_presents_the_previous_sweep(tmp_path):
    """The bytes presented at frame n are frame n-1's, through moves and
    still frames, in two host buffers in turn, each unchanged until the
    next present."""
    a = app(tmp_path, "p", run=False)
    a.canMove = True
    shown, held = [], []

    def sink(image, frame_count):
        if held:
            buf, kept = held[-1]
            assert torch.equal(buf, kept)
        held.append((image, image.clone()))
        shown.append((image.clone(), frame_count))

    swept = []
    before = profiling.counts()
    script = ["w", "", "", "s", "", "d", "", ""]
    for n, key in enumerate(script):
        a.frame(key, (10 if key else 0, 0), sink)
        assert len(shown) == n  # the first frame has nothing to show
        swept.append((to_uint8(a.image()), a.state.frame_count))
    for (image, count), (want, want_count) in zip(shown, swept):
        assert count == want_count
        np.testing.assert_array_equal(image.numpy(), want)
    ptrs = [buf.data_ptr() for buf, _ in held]
    assert len(set(ptrs)) == 2 and all(p != q for p, q in zip(ptrs, ptrs[1:]))
    assert _delta(before, "app.presented") == len(script) - 1
    assert _delta(before, "app.resets") == 3


def test_app_matches_jax_app(tmp_path):
    ref = japp(tmp_path, "j", bounces=2, max_frames=3)
    got = app(tmp_path, "t", bounces=2, max_frames=3)
    assert got.renderer.traversal == ref.renderer.traversal == "brute"
    assert np.isfinite(got.image()).all() and got.image().mean() > 0.01
    assert rmse(ref.image(), got.image()) < 1e-4


def test_app_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        App(window_size=(16, 16), scene=tiny_scene(), headless=True)


def test_interactive_loop_runs_and_quits(monkeypatch):
    pygame = pytest.importorskip("pygame")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    a = App(window_size=(16, 16), screen_size=(64, 64), bounces=1,
            scene=tiny_scene(), headless=False, run=False, device="cpu")
    frames = {"n": 0}
    real_get = pygame.event.get

    def fake_get():
        frames["n"] += 1
        if frames["n"] == 2:  # a keydown branch (camera info print)
            return [pygame.event.Event(pygame.KEYDOWN, key=pygame.K_c)]
        if frames["n"] == 3:  # L: lambertian toggle, resetFrames
            return [pygame.event.Event(pygame.KEYDOWN, key=pygame.K_l)]
        if frames["n"] >= 6:
            return [pygame.event.Event(pygame.QUIT)]
        return real_get()

    monkeypatch.setattr(pygame.event, "get", fake_get)
    a._main_interactive()
    assert frames["n"] >= 6 and a.lambertian is False
    assert a.state.frame_count >= 3
    img = a.image()
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()


# ------------------------------------------------------------------ CLI

def _actions(parser):
    return {a.dest: a for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def test_cli_parser_matches_jax():
    ref, got = _actions(j_build_parser()), _actions(build_parser())
    assert set(got) - set(ref) == {"device", "trace"}
    assert set(ref) <= set(got)
    for dest, a in ref.items():
        b = got[dest]
        assert (b.option_strings, b.default, b.choices, b.nargs, b.type,
                b.const) == (a.option_strings, a.default, a.choices,
                             a.nargs, a.type, a.const), dest
    assert got["device"].default == "cuda" and got["trace"].default is None


def test_cli_main_matches_jax_main(tmp_path):
    obj = write_latlong_obj(tmp_path / "ball" / "ball.obj", 10, 10,
                            radius=3.0, normals=True)
    flags = ["--width", "32", "--height", "24", "--bounces", "2", "--obj",
             obj, "--traversal", "packet", "--frames", "2"]
    assert j_main(flags + ["--out", str(tmp_path / "j.png")]) == 0
    assert main(flags + ["--device", "cpu",
                         "--out", str(tmp_path / "t.png")]) == 0
    ref, got = load_png(str(tmp_path / "j.png")), load_png(str(tmp_path / "t.png"))
    assert got.shape == (24, 32, 3) and got.mean() > 0.01
    assert rmse(ref, got) < 1e-4


def test_cli_checkpoint_resumes(tmp_path):
    flags = ["--device", "cpu", "--width", "16", "--height", "12",
             "--bounces", "1", "--frames", "2", "--cam-pos", "0", "0", "3",
             "--cam-dir", "180", "0", "--checkpoint", str(tmp_path / "ck.npz")]
    obj = write_latlong_obj(tmp_path / "ball.obj", 4, 6, normals=True)
    flags += ["--obj", obj, "--scale", "1.5"]
    assert main(flags + ["--out", str(tmp_path / "a.png")]) == 0
    assert main(flags + ["--out", str(tmp_path / "b.png")]) == 0
    state, cp, cd = load_checkpoint(str(tmp_path / "ck.npz"), "cpu")
    assert state.frame_count == 4
    np.testing.assert_array_equal(cp, [0, 0, 3])
    np.testing.assert_array_equal(cd, [180, 0])


def _ball_flags(tmp_path):
    obj = write_latlong_obj(tmp_path / "ball" / "ball.obj", 10, 10,
                            radius=3.0, normals=True)
    return ["--width", "32", "--height", "24", "--bounces", "2", "--obj",
            obj, "--traversal", "packet", "--frames", "2"]


@pytest.mark.parametrize("mesh,flags", [
    ("1x2", ["--devices", "2"]),
    ("2x1", ["--devices", "2", "--dp", "2"]),
    ("2x2", ["--devices", "4", "--dp", "2", "--sp", "2"])])
def test_cli_sharded_matches_jax_main(tmp_path, capsys, mesh, flags):
    """The sharded CLI on CPU meshes against the JAX CLI given the same
    flags on its virtual CPU devices; "packet" in both (the packet walk
    over each shard's rows in row-major order, as the JAX mesh's bands
    are not blocked), because the JAX mesh's "auto" picks "packet" off a
    TPU and the port's "pallas2"."""
    flags = _ball_flags(tmp_path) + flags
    assert j_main(flags + ["--out", str(tmp_path / "j.png")]) == 0
    capsys.readouterr()
    assert main(flags + ["--device", "cpu",
                         "--out", str(tmp_path / "t.png")]) == 0
    dp, sp = mesh.split("x")
    assert (f"mesh: dp={dp} x sp={sp} on {int(dp) * int(sp)} cpu device(s)"
            in capsys.readouterr().out)
    ref, got = load_png(str(tmp_path / "j.png")), load_png(str(tmp_path / "t.png"))
    assert got.shape == (24, 32, 3) and got.mean() > 0.01
    assert rmse(ref, got) < 1e-4


def test_cli_sharded_rounds_frames_up_and_resumes(tmp_path, capsys,
                                                  monkeypatch):
    """--frames 3 on sp = 2 renders 4; a second call resumes from the
    checkpoint to frame 8, and the default output is render_sharded.png."""
    monkeypatch.chdir(tmp_path)
    flags = _ball_flags(tmp_path)[:-1] + [
        "3", "--device", "cpu", "--devices", "2", "--checkpoint", "ck.npz"]
    assert main(flags) == 0
    assert "frames rounded up to 4 (multiple of sp=2)" in capsys.readouterr().out
    assert load_checkpoint("ck.npz", "cpu")[0].frame_count == 4
    assert main(flags) == 0
    assert "Resumed from ck.npz at frame 4" in capsys.readouterr().out
    state = load_checkpoint("ck.npz", "cpu")[0]
    assert state.frame_count == 8
    np.testing.assert_array_equal(
        np.round(load_png("render_sharded.png") * 255).astype(np.uint8),
        to_uint8(state.accum.numpy()))


def test_cli_mesh_prints_each_frame_and_writes_the_sequential_image(
        tmp_path, capsys):
    """``--devices 4 --dp 4 --sp 1`` runs ``App._main_headless``'s loop: a
    sync and a line each frame; at sp = 1 its PNG is the one-device CLI's
    (each slice folds its rows with the sequential arithmetic)."""
    flags = _ball_flags(tmp_path)[:-4] + ["--traversal", "bvh",
                                          "--frames", "2"]
    assert main(flags + ["--device", "cpu", "--devices", "4", "--dp", "4",
                         "--sp", "1", "--out", str(tmp_path / "m.png")]) == 0
    out = capsys.readouterr().out
    assert "mesh: dp=4 x sp=1 on 4 cpu device(s)" in out
    frames = [line.split()[1] for line in out.replace("\r", "\n").splitlines()
              if line.startswith("Frame ")]
    assert frames == ["1", "2"]
    assert main(flags + ["--device", "cpu",
                         "--out", str(tmp_path / "s.png")]) == 0
    got = load_png(str(tmp_path / "m.png"))
    assert got.mean() > 0.01
    np.testing.assert_array_equal(got, load_png(str(tmp_path / "s.png")))


def test_cli_sharded_refusals(tmp_path):
    with pytest.raises(SystemExit, match="headless-only"):
        main(["--interactive", "--devices", "2", "--device", "cpu"])
    # --device cpu is ONE cpu device unless --devices says more, as JAX's
    # make_mesh on a host with one device
    with pytest.raises(ValueError, match="!= 1 devices"):
        main(_ball_flags(tmp_path) + ["--device", "cpu", "--dp", "2"])


# ------------------------------------------------------------------ PNG

def test_save_png_decodes_with_pil(tmp_path):
    img = np.random.default_rng(0).uniform(-0.2, 1.2, (23, 41, 3))
    save_png(str(tmp_path / "a.png"), img.astype(np.float32))
    with Image.open(str(tmp_path / "a.png")) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), to_uint8(img))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_load_png_reads_pil_output(tmp_path, mode):
    y, x = np.mgrid[0:40, 0:70]
    u8 = to_uint8(np.stack([0.5 + 0.5 * np.sin(x / 5.0), y / 40.0,
                            ((x + y) % 13) / 13.0], -1))
    if mode == "RGBA":
        u8 = np.concatenate([u8, (x[..., None] * 3).astype(np.uint8)], -1)
    Image.fromarray(u8, mode).save(str(tmp_path / "p.png"))
    got = load_png(str(tmp_path / "p.png"))
    np.testing.assert_array_equal(np.round(got * 255).astype(np.uint8),
                                  u8[:, :, :3])


def _filtered_png(u8):
    """An RGB PNG whose row y uses filter type y % 5 (None, Sub, Up,
    Average, Paeth), written by the PNG specification's definitions."""
    h, w, _ = u8.shape
    rows, prev = [], np.zeros(3 * w, np.int64)
    for y in range(h):
        cur = u8[y].reshape(-1).astype(np.int64)
        ftype = y % 5
        out = np.zeros_like(cur)
        for i in range(cur.size):
            a = cur[i - 3] if i >= 3 else 0
            b = prev[i]
            c = prev[i - 3] if i >= 3 else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (cur[i] - pred) % 256
        rows.append(bytes([ftype]) + out.astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_load_png_undoes_every_filter_type(tmp_path):
    u8 = np.random.default_rng(1).integers(0, 256, (10, 9, 3), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(u8))
    with Image.open(str(path)) as im:  # the file itself is valid
        np.testing.assert_array_equal(np.asarray(im), u8)
    got = load_png(str(path))
    np.testing.assert_array_equal(np.round(got * 255).astype(np.uint8), u8)


# ------------------------------------------------------------ profiling

def test_frame_stats_caption_matches_jax():
    ref, got = JFrameStats(), FrameStats()
    for s in (ref, got):
        s.fps, s.delta = 41.6, 0.024
    assert got.caption(17, "1m 3s") == ref.caption(17, "1m 3s")


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as d:
        torch.ones(64).cumsum(0).sum()
    assert d == log_dir
    files = os.listdir(log_dir)
    assert files and os.path.getsize(os.path.join(log_dir, files[0])) > 0
