#!/usr/bin/env python3
"""Time one checkout of the port on one CUDA card, to compare commits in
turns.

    python3 chip_turns.py [--tree DIR] [--seed N]

Loads the port and the ``chip_smoke.py`` of ``DIR`` (default: this file's
directory) and prints, as its last line, one JSON object with what it
measured on the card:

* K3 (the wide-BVH traversal) per launch, in ms: the mean of 10 launches
  after a warm-up, the better of two such runs, on ``chip_smoke.py``'s
  phase-4 random rays (2,073,600) of standin-31k and of standin-1.96m;
* ms/frame at 1920x1080 and 4 bounces, 1 sample a pixel: standin-31k
  under "pallas", "auto", "bvh" and "packet", standin-1.96m under "auto"
  and "packet" (a tree before the packet walk ran K3 for "packet"), and
  the reference's 84-triangle box without its meshes under "auto" (brute
  force) and "bvh" (1 warm-up frame, then FRAMES frames timed together on
  the host clock between device syncs), and the traversal each name
  resolved to;
* the host's time to enqueue one step (a frame), with no device sync
  inside it: the median of FRAMES steps issued back to back;
* G9 (the packet walk) per launch, in ms (the better of two means of 5
  launches), on ``chip_smoke.py``'s phase-3c random rays of standin-31k
  and on the five bounce segments of one 1080p "packet" frame of it, and
  G8 (the brute-force sweep) per launch (the better of two means of 10)
  on the same kind of random rays over the box;
* ms per converged frame of standin-31k over (dp, sp) meshes (2, 1),
  (2, 2) and (4, 1) of the one card repeated, and the host's time to
  enqueue one step of it (the median of SWEEPS steps back to back);
* device ms and launches a frame by kernel group (``chip_smoke.py``'s
  phase-11 groups: G3 reorder and restore, the sort, K1, ...) over
  PROFILED more "auto" frames of standin-31k, of standin-1.96m and of the
  box, and "packet" frames of standin-31k, under ``torch.profiler``, G8's
  and G9's in-frame ms a launch, and the G3 reorder's in-frame ms (every
  group whose name starts with "G3 reorder": one group in trees before
  the reorder's index pass and gather were profiled apart, two after).

Both trees are driven through the same calls: ``Renderer`` and
``chip_smoke.py``'s scene and ray helpers, and K3 through its wrapper,
``traverse_wide(scene, o3, d3, t0)``.  To compare a
parent with a change, unpack each with ``git archive`` into a directory
that ``.gitignore`` lists and run this script on them in turns (parent,
change, change, parent) in one call on one card.  The card's name and
power limit are in the output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

FRAMES = 8
PROFILED = 4
SWEEPS = 4  # timed sweeps of a mesh
MESHES = ((2, 1), (2, 2), (4, 1))


def frame_ms(torch, data, camera, traversal):
    """(ms/frame over FRAMES 1080p frames after one warm-up, the median
    host time of one ``Renderer.step`` (a frame at tile_size 1) issued
    back to back, the traversal the name resolved to, the renderer and
    its state)."""
    from opengl_raytracer_torch import RenderConfig, Renderer

    r = Renderer(data, RenderConfig(width=1920, height=1080, bounces=4,
                                    traversal=traversal), device="cuda")
    state = r.render(camera, frames=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = r.render(camera, frames=FRAMES, state=state)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000.0 / FRAMES
    host = []
    for _ in range(FRAMES):  # back to back, as render() issues them
        h0 = time.perf_counter()
        state = r.step(state, camera)
        host.append((time.perf_counter() - h0) * 1000.0)
    torch.cuda.synchronize()
    return ms, sorted(host)[len(host) // 2], r.traversal, r, state


def frame_groups(torch, cs, r, state, camera):
    """{group: [device ms, launches] a frame} over PROFILED more frames of
    renderer ``r``, by ``cs`` (the tree's chip_smoke) kernel groups."""
    groups = {}
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        r.render(camera, frames=PROFILED, state=state)
        torch.cuda.synchronize()
    for name, a, b in cs._device_events(prof):
        g = groups.setdefault(cs._kernel_group(name), [0.0, 0])
        g[0] += (b - a) / 1e3 / PROFILED
        g[1] += 1 / PROFILED
    return groups


def best_ms(cs, fn, iters):
    """The better of two means of ``iters`` calls of ``fn``, in ms."""
    return min(cs.cuda_ms(fn, iters) for _ in range(2))


def g9_launch_ms(cs, data, camera, seed):
    """G9's ms a launch on phase 3c's random rays of ``data`` and on the
    five bounce segments of one 1080p "packet" frame of it."""
    from opengl_raytracer_torch.ops import traversal
    from opengl_raytracer_torch.ops.intersect import BIG
    from opengl_raytracer_torch.renderer import effective_max_leaf

    leaf = effective_max_leaf(data)
    out = []
    for o3, d3, t0 in (cs.k1_rays(data, camera, seed, "cuda"),
                       *cs.frame_segments(data, camera, "packet", "packet")):
        active = t0 > -BIG
        out.append(best_ms(cs, lambda: traversal.raycast_packet(
            data, o3, d3, active, leaf), 5))
    return out


def g8_launch_ms(cs, box, camera, seed):
    """G8's ms a launch on phase 3c's random rays over ``box``."""
    from opengl_raytracer_torch.ops import intersect
    from opengl_raytracer_torch.ops.intersect import BIG

    o3, d3, t0 = cs.k1_rays(box, camera, seed, "cuda")
    active = t0 > -BIG
    return best_ms(cs, lambda: intersect.raycast_brute(box, o3, d3, active),
                   10)


def mesh_ms(torch, data, camera, dp, sp):
    """(ms per converged 1080p frame, host ms a step) of a (dp, sp) mesh of
    the one card repeated: 1 warm-up sweep, then SWEEPS sweeps of sp
    frames each, one step each, timed together between device syncs; the
    host's time is the median step's enqueue."""
    from opengl_raytracer_torch import RenderConfig
    from opengl_raytracer_torch.parallel import ShardedRenderer, make_mesh

    sr = ShardedRenderer(data, RenderConfig(width=1920, height=1080,
                                            bounces=4),
                         make_mesh(devices=["cuda"] * (dp * sp), dp=dp, sp=sp))
    state = sr.render(camera, frames=sp)
    host = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SWEEPS):
        h0 = time.perf_counter()
        state = sr.step(state, camera)
        host.append((time.perf_counter() - h0) * 1000.0)
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1000.0 / (sp * SWEEPS),
            sorted(host)[len(host) // 2])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(
        __file__)), help="root of the checkout to time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: chip_turns.py times the port on one",
              file=sys.stderr)
        return 1
    import chip_smoke as cs  # the tree's own

    if os.path.dirname(os.path.abspath(cs.__file__)) != tree:
        raise RuntimeError(f"chip_smoke.py came from {cs.__file__}")
    from opengl_raytracer_torch import make_camera
    from opengl_raytracer_torch.ops import pallas_traversal as wide

    camera = make_camera(cs.CAM_POS, cs.CAM_DIR)
    out = dict(tree=tree, card=cs.card_line(), torch=torch.__version__)
    # the profiled frames last: the profiler slows the host's launches
    # for the rest of the process
    profiled = []
    from opengl_raytracer_torch import Scene

    box = Scene(cs.standin_objects(83, 166)[2:]).send("cuda")
    out["g8_random_box_ms"] = g8_launch_ms(cs, box, camera, args.seed)
    for name in ("auto", "bvh"):
        ms, host, resolved, r, state = frame_ms(torch, box, camera, name)
        out[f"{name}_box_ms_per_frame"] = ms
        out[f"{name}_box_host_ms_per_step"] = host
        out[f"{name}_box_resolved"] = resolved
        if name == "auto":
            profiled.append((f"{name}_box", r, state))
        del r, state
    del box
    for tag, cells, names in (("1.96m", (700, 1400), ("auto", "packet")),
                              ("31k", (83, 166), ("pallas", "auto", "bvh",
                                                  "packet"))):
        scene, data = cs.make_scene(*cells, "cuda")
        out[f"triangles_{tag}"] = scene.total_triangles
        del scene
        o3, d3, t0 = cs.k1_rays(data, camera, args.seed, "cuda")
        out[f"k3_random_{tag}_ms"] = best_ms(
            cs, lambda: wide.traverse_wide(data, o3, d3, t0), 10)
        del o3, d3, t0
        if tag == "31k":
            g9 = g9_launch_ms(cs, data, camera, args.seed)
            out["g9_random_31k_ms"] = g9[0]
            out["g9_packet_segments_31k_ms"] = g9[1:]
            for dp, sp in MESHES:
                (out[f"mesh_{dp}x{sp}_{tag}_ms_per_frame"],
                 out[f"mesh_{dp}x{sp}_{tag}_host_ms_per_step"]) = mesh_ms(
                    torch, data, camera, dp, sp)
        for name in names:
            ms, host, resolved, r, state = frame_ms(torch, data, camera, name)
            out[f"{name}_{tag}_ms_per_frame"] = ms
            out[f"{name}_{tag}_host_ms_per_step"] = host
            out[f"{name}_{tag}_resolved"] = resolved
            if name == "auto" or (name, tag) == ("packet", "31k"):
                profiled.append((f"{name}_{tag}", r, state))
            del r, state
        del data
        torch.cuda.empty_cache()
    for key, r, state in profiled:
        groups = frame_groups(torch, cs, r, state, camera)
        out[f"{key}_groups"] = groups
        out[f"{key}_reorder_ms_per_frame"] = sum(
            ms for g, (ms, _) in groups.items() if g.startswith("G3 reorder"))
        for g, tag in (("G8 brute sweep", "g8"), ("G9 packet walk", "g9")):
            if g in groups:
                out[f"{key}_{tag}_in_frame_ms"] = groups[g][0] / groups[g][1]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
