"""Command-line entry point (the port of ``opengl_raytracer_tpu/__main__.py``).

The reference has no CLI: its knobs are hard-coded in the ``__main__``
block (reference: main.py:447-470).  Here the same knobs (and a few more)
are flags, those of the JAX package plus ``--device`` and ``--trace``; the
default invocation renders the reference's default scene headlessly on the
CUDA card and writes a PNG.

    python -m opengl_raytracer_torch --width 1920 --height 1080 --bounces 4 \\
        --out render.png
    python -m opengl_raytracer_torch --device cpu --width 96 --height 54 \\
        --frames 2 --obj path/to/model.obj --out render.png
    python -m opengl_raytracer_torch --interactive      # pygame window
    python -m opengl_raytracer_torch --devices 4 --dp 2 --sp 2  # 4 cards
    python -m opengl_raytracer_torch --device cpu --devices 2 --frames 2
    python -m opengl_raytracer_torch --frames 8 --trace trace_dir

Assets named by the default scene (``stanford_minidragon``, ``sphere``)
are searched along ``OGLRT_MODELS_PATH`` (``models/mesh.py``).
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="opengl_raytracer_torch",
        description="Progressive path tracer on PyTorch + CUDA",
    )
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--bounces", type=int, default=7,
                   help="bounce count (the loop runs bounces+1, like the reference)")
    p.add_argument("--spp", type=int, default=1, help="rays per pixel per frame")
    p.add_argument("--jitter", type=float, default=0.001)
    p.add_argument("--no-lambertian", action="store_true")
    p.add_argument("--sky", type=float, default=1.0, help="sky brightness")
    p.add_argument("--tiles", type=int, default=1, help="tiles per axis")
    p.add_argument("--frames", type=int, default=32,
                   help="progressive frames to accumulate (headless)")
    p.add_argument("--out", default=None, help="output PNG path")
    p.add_argument("--dragon", default="stanford_minidragon",
                   help="dragon asset name/path for the default scene")
    p.add_argument("--obj", default=None,
                   help="render a single OBJ (any path) instead of the default scene")
    p.add_argument("--scale", type=float, default=None,
                   help="scale for --obj (default: auto-frame the mesh "
                        "to ~16 world units so any OBJ is visible)")
    p.add_argument("--cam-pos", type=float, nargs=3, default=None)
    p.add_argument("--cam-dir", type=float, nargs=2, default=None,
                   help="yaw pitch in degrees")
    p.add_argument("--traversal", default="auto",
                   choices=["auto", "brute", "bvh", "packet", "pallas", "pallas2"])
    p.add_argument("--leaf", type=int, default=32, help="BVH max leaf triangles")
    p.add_argument("--bvh-method", default="sah", choices=["sah", "mean"])
    p.add_argument("--interactive", action="store_true",
                   help="open a pygame window (needs a display)")
    p.add_argument("--screen-size", type=int, nargs=2, default=None,
                   metavar=("SW", "SH"),
                   help="display window size; default (interactive mode) is "
                        "derived from the monitor like the reference "
                        "(main.py:456-468)")
    p.add_argument("--checkpoint", default=None,
                   help="resume from / save to this .npz checkpoint")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the render across N devices (headless; "
                        "(dp, sp) mesh via parallel.sharding): the first N "
                        "CUDA cards, or with --device cpu the CPU N times")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel mesh axis (rows); default derived")
    p.add_argument("--sp", type=int, default=None,
                   help="sample-parallel mesh axis (frames); default 2 "
                        "when the device count is even")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on: 'cuda' (default; the "
                        "hand-written kernels) or 'cpu' (their plain "
                        "versions); with --devices/--dp/--sp only its "
                        "type counts")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="profile the headless run (torch.profiler) and "
                        "write DIR/trace.json, a Chrome trace holding the "
                        "program's spans (scene build, steps, syncs)")
    return p


def monitor_screen_size(render_height: int) -> tuple[int, int] | None:
    """Display size from the monitor via a throwaway tkinter root, with the
    reference's sizing rule (main.py:456-468): a render shorter than the
    monitor displays at monitor/1.15; otherwise the display matches the
    render height at the monitor's aspect.  Returns None when no display /
    tkinter is available (headless fallback: display = render size)."""
    try:
        import tkinter as tk

        window = tk.Tk()
        mw = window.winfo_screenwidth()
        mh = window.winfo_screenheight()
        window.destroy()
    except Exception:
        return None
    aspect = mw / mh
    if render_height < mh:
        return (int(mw // 1.15), int(mh // 1.15))
    return (int(render_height * aspect), int(render_height))


def _main_sharded(args, scene, cam_pos, cam_dir) -> int:
    """Headless multi-device render: ShardedRenderer over a (dp, sp) mesh.

    Pixel rows shard over ``dp`` and frame samples over ``sp``; images
    match the sequential renderer (tests/test_torch_sharding.py).  The mesh
    is the first ``--devices`` CUDA cards, or with ``--device cpu`` the CPU
    repeated ``--devices`` times (the counterpart of the JAX package's
    virtual CPU devices).  The loop is ``App._main_headless``'s: the
    steps of a sweep, then a sync of every card and the sweep's ms
    printed."""
    import time

    import numpy as np
    import torch

    from opengl_raytracer_torch.models.scene import Scene
    from opengl_raytracer_torch.ops.camera import make_camera
    from opengl_raytracer_torch.parallel.sharding import (ShardedRenderer,
                                                          make_mesh)
    from opengl_raytracer_torch.presets import (DEFAULT_CAM_DIR,
                                                DEFAULT_CAM_POS,
                                                default_objects)
    from opengl_raytracer_torch.utils.checkpoint import (load_checkpoint,
                                                         save_checkpoint)
    from opengl_raytracer_torch.utils.config import RenderConfig
    from opengl_raytracer_torch.utils.image import save_png
    from opengl_raytracer_torch.utils.profiling import device_sync

    if scene is None:
        scene = Scene(default_objects(args.dragon), max_leaf_tris=args.leaf,
                      bvh_method=args.bvh_method, verbose=True)
    cfg = RenderConfig(
        width=args.width, height=args.height, bounces=args.bounces,
        rays_per_pixel=args.spp, jitter_amount=args.jitter,
        lambertian=not args.no_lambertian, sky_brightness=args.sky,
        tile_size=args.tiles, max_leaf_tris=args.leaf,
        traversal=args.traversal,
    )
    kind = torch.device(args.device).type
    devices = None if kind == "cuda" else [torch.device(kind)] * args.devices
    mesh = make_mesh(n_devices=args.devices if args.devices > 1 else None,
                     dp=args.dp, sp=args.sp, devices=devices)
    print(f"mesh: dp={mesh.shape['dp']} x sp={mesh.shape['sp']} on "
          f"{mesh.devices.size} {mesh.devices.flat[0].type} device(s)")
    r = ShardedRenderer(scene, cfg, mesh)

    cam_pos_arr = np.asarray(
        cam_pos if cam_pos is not None else DEFAULT_CAM_POS, np.float32)
    cam_dir_arr = np.asarray(
        cam_dir if cam_dir is not None else DEFAULT_CAM_DIR, np.float32)

    state = None
    if args.checkpoint and os.path.exists(args.checkpoint):
        loaded, cp, cd = load_checkpoint(args.checkpoint, "cpu")
        state = r.restore_state(loaded)
        if cp is not None:
            cam_pos_arr = cp.astype(np.float32)
            cam_dir_arr = cd.astype(np.float32)
        print(f"Resumed from {args.checkpoint} at frame {state.frame_count}")
    camera = make_camera(cam_pos_arr, cam_dir_arr)

    sp = r.frames_per_step
    frames = -(-args.frames // sp) * sp
    if frames != args.frames:
        print(f"frames rounded up to {frames} (multiple of sp={sp})")
    if state is None:
        state = r.init_state()
    tiles = cfg.num_tiles_x * cfg.num_tiles_y
    t0 = last = time.time()
    for _ in range(frames // sp * tiles):
        state = r.step(state, camera)
        if state.tile_x == 0 and state.tile_y == 0:
            device_sync(state.accum)  # every card: honest per-frame timing
            now = time.time()
            print(f"\rFrame {state.frame_count}  {(now - last) * 1000:.0f} "
                  f"ms  total {now - t0:.1f} s", end="", flush=True)
            last = now
    print()
    img = r.image(state)
    dt = time.time() - t0
    print(f"{frames} frames in {dt:.1f} s ({frames / dt:.2f} frames/s)")

    out = args.out or "render_sharded.png"
    save_png(out, img)
    print(f"Wrote {out}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state, cam_pos_arr, cam_dir_arr)
        print(f"Checkpoint saved to {args.checkpoint}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.trace is None:
        return _main(args)
    if args.interactive:
        raise SystemExit("--trace is headless-only")
    from opengl_raytracer_torch.utils.profiling import trace

    with trace(args.trace):
        code = _main(args)
    print(f"Wrote {os.path.join(args.trace, 'trace.json')}")
    return code


def _main(args) -> int:
    import numpy as np

    from opengl_raytracer_torch.app import App
    from opengl_raytracer_torch.models.mesh import Mesh
    from opengl_raytracer_torch.models.rect import Rect
    from opengl_raytracer_torch.models.scene import Scene
    from opengl_raytracer_torch.utils.checkpoint import (load_checkpoint,
                                                         save_checkpoint)

    scene = None
    cam_pos, cam_dir = args.cam_pos, args.cam_dir
    if args.obj:
        scale = args.scale
        obj_pos = [0.0, 0.0, 25.0]
        if scale is None:
            # Auto-frame: normalize the mesh's largest extent to ~20 world
            # units and recenter on the view axis, so an arbitrary OBJ fills
            # the default camera's view instead of rendering as a speck (or
            # filling the sky) at its native scale.
            probe = Mesh([0, 0, 0], [0, 0, 0], args.obj, scale=1.0)
            lo = probe.pos.min(axis=0)
            hi = probe.pos.max(axis=0)
            ext = float((hi - lo).max())
            scale = 20.0 / max(ext, 1e-6)
            center = (lo + hi) * 0.5 * scale
            obj_pos = [0.0 - float(center[0]), 0.0 - float(center[1]),
                       25.0 - float(center[2])]
            print(f"--obj auto-frame: extent {ext:.3g} -> scale {scale:.3g}, "
                  f"pos {[round(x, 2) for x in obj_pos]}")
        objs = [
            Mesh(obj_pos, [0, 0, 0], args.obj, color=[0.8, 0.8, 0.8],
                 roughness=1.0, scale=scale),
            Rect([40, 0.2, 40], [0, -10, 25], [0, 0, 0], color=[0.7, 0.7, 0.7],
                 roughness=1.0),
        ]
        scene = Scene(objs, max_leaf_tris=args.leaf, bvh_method=args.bvh_method,
                      verbose=True)
        if cam_pos is None:
            cam_pos = [0.0, 0.0, 0.0]
        if cam_dir is None:
            cam_dir = [0.0, 0.0]

    if args.devices > 1 or args.dp or args.sp:
        if args.interactive:
            raise SystemExit("--devices/--dp/--sp is headless-only")
        return _main_sharded(args, scene, cam_pos, cam_dir)

    screen_size = tuple(args.screen_size) if args.screen_size else None
    if screen_size is None and args.interactive:
        screen_size = monitor_screen_size(args.height)

    app = App(
        window_size=(args.width, args.height),
        screen_size=screen_size,
        bounces=args.bounces,
        rays_per_pixel=args.spp,
        jitter_amount=args.jitter,
        lambertian=not args.no_lambertian,
        skyIllumination=args.sky,
        tileSize=args.tiles,
        scene=scene,
        dragon=args.dragon,
        headless=not args.interactive,
        max_frames=args.frames,
        output=args.out,
        run=False,
        max_leaf_tris=args.leaf,
        traversal=args.traversal,
        device=args.device,
    )
    if cam_pos is not None:
        app.camPos = np.array(cam_pos, dtype=np.float32)
    if cam_dir is not None:
        app.camDir = np.array(cam_dir, dtype=np.float32)
    app.camera = app._make_camera()

    if args.checkpoint and os.path.exists(args.checkpoint):
        state, cp, cd = load_checkpoint(args.checkpoint, app.device)
        app.state = state
        if cp is not None:
            app.camPos, app.camDir = cp.astype(np.float32), cd.astype(np.float32)
            app.camera = app._make_camera()
        print(f"Resumed from {args.checkpoint} at frame {state.frame_count}")

    app.main()

    if args.checkpoint:
        save_checkpoint(args.checkpoint, app.state, app.camPos, app.camDir)
        print(f"Checkpoint saved to {args.checkpoint}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
