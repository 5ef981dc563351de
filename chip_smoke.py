#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py [--seed N] [--out DIR] [--cards N]

With ``--cards N`` (N > 1, a machine with N cards) it runs only phase 10's
meshes, each shard on a card of its own (``cuda:0 ..``), with the copies a
step makes between cards (the sp sums' and the slices' owners') timed; the
rest of this text is the run without it, which needs one card.

Phases; each raises on failure, and the script then exits non-zero:

0. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions.  No CUDA card -> the script stops here.
1. build: nvcc compiles ``opengl_raytracer_torch/csrc/*.cu`` for sm_90a.
2. K2 (fused shade, ``csrc/shade.cu``) against its plain torch version on
   1920x1080 = 2,073,600 rays of seeded random hits and path state.
3. K1 (sub-block traversal, ``csrc/subblock_traversal.cu``): the main
   path's launch, ``traverse_parts`` over the scene's one part (the chain
   kernel of one part), against its plain torch version (``_chain_plain``)
   on two ray sets: 2,073,600 rays, half primary rays of the 1080p camera
   and half bounce-like rays from random points in the scene; and the five
   bounce segments of one 1080p "auto" frame, each captured as
   ``raytrace`` hands it to the traversal (after the reorder sort).  On
   each set t, tri, u, v and slot must equal the plain version's bit for
   bit, with one launch walking one part and no stack overflow; the
   script prints ms per launch, the plain version's per-ray counts (node
   visits, leaf octets, loop steps) and the share of a warp's lanes they
   keep busy, and the operations, bound and share of bound.
3b. k1prof: the profile build of K1 (``probes/k1.py``, the same source
   compiled with ``-DOGLRT_K1_PROFILE``) on both ray sets: its raw hits
   (t, slot, u, v) must equal the plain walk's (``_traverse_plain``) and
   its visit, octet and barycentric-test counts the plain walk's; it
   prints cycles per stage, per visit and per fetch, and the ms of a
   profile launch on the random rays.
3c. glue: the main path's glue kernels against their plain torch versions
   at 2,073,600 rays, each bit for bit (max |d| 0): G1, the ray front
   (``csrc/ray_front.cu``, each ray's pixel and frame number from its
   index and the step block's window), on a quarter of the 1080p frame's
   rows with frames_per_step = 4 from frame 2^32 - 2 (the frame numbers
   wrap), and on the whole frame at frame 2^32 - 1, also in the "packet"
   traversal's 8x16 block order at frames_per_step 1 and 2; G2, the int32
   sort keys
   (``csrc/sort_keys.cu``), on phase 3's ray sets and on its random rays
   with out-of-box origins, NaN and +-inf in their columns (and the
   stable argsort of the int32 keys equals that of the uint32 keys, each
   timed); G3, reorder and restore (``csrc/permute.cu``), byte for byte
   with return_seed on and off, on (a) 12 random columns with ~30% of the
   rays dead (a live ray's light +0.0) under a random permutation and
   under the stable sort of the frame's primary rays' keys (restore after
   reorder is the identity), and (b) the four pre-reorder states and the
   restore input of one 1080p "auto" frame, captured by wrapping
   ``permute.reorder`` and ``permute.restore`` during the frame (every
   live ray's light must be +0.0 in bits there); with seed
   reconstruction (the index pass rebuilds a live ray's seed, the gather
   skips its seed row; the main path's reorder at 1 spp) on those four
   states and on the eight of one frames_per_step-2 step from frame
   2^32 + 3 (two chunks, the second padded), byte for byte against the
   plain version and against the carried-seed reorder (it prints the live
   padding rays checked), and on the frame's four states against
   ``permute.cu`` built with 32-bit index math
   (``-DOGLRT_RECON_INDEX=uint32_t``; the port's index pass uses 64-bit),
   byte for byte and timed in turns; it prints each set's live share, ms (the
   frame's states: with reconstruction, in turns with the carried-seed
   reorder), plain ms, library ms (``torch.index_select`` of a stacked
   (12, R) buffer, ``index_copy_`` of the (3, R) light), the bytes bound
   at the live share beside the earlier 141-byte yardstick, and the
   scattered 32-byte sectors and the GB/s they imply (the reorder's ms
   covers its two launches, index pass and gather); G5, K3's wrapper
   prologue and epilogue (``csrc/wide_epilogue.cu``), on K3's own output
   for phase 3's sets; G6, the band fold
   (``csrc/band_fold.cu``), on the whole 1080p frame as one band at frame
   2^32 - 2 and on three tiles of tile_size 7 (remainders on both axes)
   with frames_per_step 2, into the buffer the step block names, and on
   the whole frame in 8x16 block order at frames_per_step 1 and 2; and the
   step block's write (``csrc/step_block.cu``) against a copy of the same
   words, timed in turns with a ``copy_`` from pinned host memory (the
   library call); G7, the "bvh" walk (``csrc/bvh_walk.cu``, over the
   scene's node and triangle records), on phase 3's kind of rays over the
   84-triangle box of phase 7 and over standin-31k, with a live ray's
   node visits, triangle tests and candidates; G8, the brute-force sweep
   (``csrc/brute_sweep.cu``), on the same kind of rays over the box, with
   the pairs and candidates a live ray and the time of the matmul sweep it
   replaced (``matmul_sweep``, kept here only as that yardstick); G9, the
   packet walk (``csrc/packet_walk.cu``, a block a packet over G7's
   records, each opened leaf staged in shared memory), on the same
   kind of rays over the box and over standin-31k and on the five bounce
   segments of one 1080p "packet" frame of standin-31k (captured after
   the reorder as phase 3 captures K1's), with a packet's node visits and
   slot tests against the union of what its live rays visit and test
   alone (the per-ray walk stepped in ``_packet_union``), and the waste:
   the lanes' visits and tests over the live rays' own.  Each prints ms
   per launch, the plain version's, its bound and the share; G9's bound
   is the live rays' own per-ray work, priced as G7's is, with the lanes'
   (``lane_bound_ms``) beside it.
3d. radix: G10, the sort (``csrc/radix_sort.cu``), on G2's keys of one
   1080p "auto" frame as the integrator hands them to its four sorts
   (captured by wrapping ``radix_sort.sort_rays``), whole (2,073,600) and
   their first 518,400 (a quarter frame, as a minidragon-mesh4 card
   sorts): equal to ``torch.sort(keys, stable=True)`` with the indices
   as int32, bit for bit; ms a sort in turns with that library call
   (``library_ms``, also the row's plain version), warm and after a
   128 MB write that flushes L2 (``ms_after_flush``), and the two
   bounds: 12 bytes a key (read a key, write a key and an index) and the
   LSD floor (64 bytes a key at 8-bit digits), each at 3.35 TB/s.
4. K3 (wide-BVH traversal, ``csrc/wide_traversal.cu``, over the scene's
   Hopper tables ``SceneData.k3``) against its plain torch version (over
   the same tables) on four ray sets: (a) phase 3's 2,073,600 random rays;
   (b) the five bounce segments of one 1080p "pallas" frame of the
   stand-in scene, captured as phase 3's are; (c) and (d) the same two on
   the 1,964,180-triangle scene of phase 4c.  On each, t, slot, u and v
   must equal the plain version's bit for bit, with no overflow; the
   script prints ms per launch, the plain version's per-ray counts (node
   visits, leaf entries, octets and triangles tested, each leaf's own;
   barycentric tests), the busy-lane share,
   and the operations both at a full triangle test per slot (the earlier
   yardstick) and as the kernel does them (t first), the bound and the
   share.
4b. k3prof: the profile build of K3 (``probes/k3.py``, the same source
   compiled with ``-DOGLRT_K3_PROFILE``) on the primary rays and the
   sorted first-bounce rays (segments 0 and 1) of both scenes: its hits
   must equal the kernel's and its visit, leaf, octet, triangle and
   candidate counts the plain version's; it prints cycles per stage, the
   octets and triangles tested per leaf entry and the share of them that
   are the entered leaf's own (1: no over-read).  Then its octet
   fetch reads octets 0, 1, 7, 8, 9, 100, 101, 555 and the last through
   K3's own loads, which must equal ``unpack_octets`` of the same rows
   (the triangle tiles' slices) bit for bit, on both scenes.  It prints
   the ms of a profile launch and of the kernel on the primary rays, and
   of the fetch.
4c. big: the reference's default scene with a 700 x 1400-cell bumpy
   sphere, 1,964,180 triangles: past the sub-block builder's caps, so
   "auto" must resolve to "pallas" (K3 + K2).  Host build and upload
   seconds, 1 warm-up and 4 timed 1080p frames, K3 = K2 = 5 x frames and
   no K1 or probe launch, peak memory, and a 96x54 frame on the card
   against the CPU's.
4d. k2probe: K2's row fetch apart from its math (``probes/k2.py``, the
   counterpart of experiments/shadeglue_ab.py): two CUDA sums over
   2,073,600 rows gathered by sorted, jittered slots from 30,336, one
   from K2's (S, 24) row table and one from a (24, S) table, each equal
   to its plain version bit for bit; their ms and bytes bound beside
   phase 2's K2.
5. main path: ``Renderer`` at 1920x1080 with 4 bounces on a 31,736-triangle
   stand-in of the reference's default scene (its seven boxes, a bumpy
   tessellated sphere for the dragon, a smooth sphere for the mirror ball);
   "auto" resolves to "pallas2" (K1 + K2); 1 warm-up and 8 timed frames,
   each step a block write and a replay of the step's CUDA graph; every
   kernel's launch count (per frame: K1 5, one a segment walking every
   part, so parts x 5 parts walked, K2 5, G1 1 per chunk, G2 4, the
   reorder 8 (4 calls of two launches), the restore 1, G5 5 (K1's entry
   t), G6 1, the block write 1; every
   other render phase checks the glue counts of its own path the same
   way, K3's paths with G5 10 a frame), image checks; then a 96x54 frame
   rendered on the card and on the CPU (the plain versions), which must
   agree.
5b. graph: the compiled step on standin-31k "auto", standin-1.96m "auto"
   and standin-31k "pallas": replayed 1080p frames against the step's
   body run eagerly, bit for bit after every frame of a script with a
   lambertian toggle, a sky change and a camera move with a reset; the
   host time of ``Renderer.step`` (no device sync inside it) eager and
   replayed, on an idle card and back to back, ms/frame of both, the
   launches a frame and the peak device memory; every eager reorder must
   reconstruct the seed.  Then one 1080p standin-31k "auto" frame with
   seed reconstruction against the same frame with the seed carried
   (``render_pixels``'s ``_seed_recon`` off), both replayed, bit for bit.
   (It runs after phase 4c, while the big scene is loaded.)
5c. cadence: the reorder cadence ``RenderConfig.sort_every`` on
   standin-31k "auto" (K1), standin-31k "pallas" (K3) and standin-1.96m
   "auto" (K3), 1080p, 4 bounces: two replayed frames at sort_every 1, 2,
   3 and 4, accum bit for bit against sort_every 1, each with its
   cadence's launches (reorders before segment i >= 1 where (i - 1) %
   sort_every == 0: 4, 2, 2 and 1 a frame); a replay at cadence 2 against
   the eager body, bit for bit; K1 (or K3) on segment 2 of a cadence-2
   frame (the first segment whose rays are one sort stale, the dead among
   the live) bit for bit against its plain version, beside the sorted
   segments 1 and 2 of a cadence-1 frame, with the node visits, octets and
   busy-lane shares of each, its ms and (K1) its profile build's stage
   cycles; then cadences 1, 2, 4, 1, 2, 4 timed in turns, 8 replayed
   frames a run, with the launches of each run checked and the path's
   peak device memory (its four renderers' graphs).
5d. display: the App's display path (``App.frame``) at 1920x1080, 7
   bounces on phase 5's scene: the 8-bit conversion kernel
   (``csrc/to_uint8.cu``) byte for byte against ``to_uint8`` of the same
   ``accum`` (also stretched past [0, 1], and the half steps), its device
   ms hot, after an L2 flush and in frame against its bytes bound; the App's
   frame body timed in turns with the parent's (a device clone shown one
   frame later by a pageable ``.cpu()`` and the host's ``to_uint8``) by
   the host clock and CUDA events; the copy to pinned memory's ms and the
   share of it that overlapped other device work.
5e. turnaround: the CLI frame's host turnaround, untraced, at the App's
   defaults on phase 5's scene: 200 frames of the CLI's loop (jobs of 32
   frames from a reset, each frame ``Renderer.step`` then
   ``device_sync``), the host's clock read from the wait's return to the
   replay's return, split into the read, the loop, the block and the
   replay's call, and the step's time after the replay; in turns with 200
   frames of ``App.frame``'s loop (cli, app, app, cli), ms a frame each,
   and the steps that found their block written ahead.
6. the K3 path: the same with ``traversal="pallas"`` (K3 + K2): launch
   counts, the image against phase 5's (the same seeds: only exact-t ties
   may differ), and the 96x54 card-vs-CPU check.
7. small paths: the reference's 84-triangle box without its meshes, at
   96x54 with 4 bounces, on the card and on the CPU, for "auto" (which
   resolves to brute force, G8), "bvh" (G7) and "packet" (G9 5 a frame, no
   K3 or G5), each step a
   graph replay; then 1920x1080 / 4 bounces, 1 warm-up and 8 timed
   replayed frames each, of the box under "auto" (G8 5 a frame) and "bvh"
   (G7 5 a frame) and of standin-31k under "bvh": ms/frame and the
   launches (K2 5 a frame, G1, G6 and the block write 1, no G2, G3, K1 or
   K3).
7b. packet: ``traversal="packet"`` (G9 + K2, the rays in 8x16 pixel
   blocks) at 1920x1080 / 4 bounces on standin-31k and on standin-1.96m,
   1 warm-up and 8 timed replayed frames each: ms/frame, G9 and K2 5 a
   frame, the reorder's glue, no K1, K3 or G5; standin-31k's image
   against phase 5's (rmse <= 1e-3); two replayed frames against the
   eager body bit for bit; 96x54 (not blocked) and 96x48 (blocked) frames
   on the card and the CPU.
8. multi-part: the phase-5 scene with a finer bumpy sphere (94,180
   triangles, 4 sub-block parts at the JAX package's 7.5 MB budget; the
   card's keeps it in one): K1's chain kernel on the five sorted bounce
   segments of one 1080p frame against the plain chain
   (``_chain_plain``, on the card's tensors), bit for bit, one launch a
   segment walking the 4 parts, with each segment's ms, the plain chain's
   per-ray steps, and the operations, bound and share of bound; then 1
   warm-up and 4 1080p frames, each timed alone (its own device sync).
9. cli: the user's entry point.  Phase 5's two spheres are written as OBJ
   files (``stanford_minidragon/dragon.obj``, bare ``v``/``f``;
   ``sphere/sphere.obj``, ``v//n`` with normals) under
   ``OGLRT_MODELS_PATH``; ``presets.default_scene()`` must load them with
   the native parser into 31,736 triangles.  ``python -m
   opengl_raytracer_torch``'s ``main`` runs twice at 1920x1080 / 4 bounces
   / 4 frames with a checkpoint (the second call resumes to frame 8):
   "auto" must resolve to "pallas2" with the K1/K2 counts of 4 frames and
   no K3 launch.  The resumed image must equal 8 straight frames of
   ``App`` (rmse <= 1e-7), the PNG must decode to the image's bytes, and a
   96x54 ``App`` frame on the card must agree with the CPU's.
10. sharded: multi-device rendering (``parallel/sharding.py``) on the one
   card.  ``ShardedRenderer`` renders phase 5's scene at 1920x1080 / 4
   bounces over meshes of the card repeated, (dp, sp) in ``MESHES``: one
   sweep of sp frames each, "auto" resolving to "pallas2" with 5 x dp x
   sp K1 launches (each walking every part), 5 x dp x sp K2 and no K3, held against a
   sequential ``Renderer`` at sp frames (rmse <= 1e-6), its ``accum``
   dp slices of (1080/dp, 1920, 3), slice j on the mesh's devices[j, 0],
   and one fold and one block write a slice the band reaches (dp a step:
   the band is the whole frame); then timed, with each shard's host time a
   step (its block write and graph replay) and each step's (the shards,
   the sp sums, the copies and the folds), and the bytes a step copied
   between distinct devices (0 on one card) beside what it would copy on
   distinct cards and what it copied when ``accum`` lived on one card.
   On one card the shards run one after
   another, so this is the cost of splitting a frame, not a scaling
   number.  The CLI's ``main`` with ``--dp 1 --sp 1`` runs phase 9's
   two calls on the OBJ-loaded default scene: the resumed checkpoint must
   equal phase 9's 8 straight frames (rmse <= 1e-7).  Last, a 96x54
   frame of a (2, 2) mesh on the card must agree with the same mesh of
   the CPU.
11. profile: ``torch.profiler`` (card activity only) over 4 more 1080p
   frames of phase 5's scene and of phase 4c's under "auto", of phase 7's
   box under "auto" and of standin-31k under "bvh" and "packet" (the
   replays' kernels if the profiler sees inside a graph, else the eager
   body's; it says which): device ms and launches per frame by kernel
   group (K1, K3, K2, G1-G9 each, G3's reorder as its index pass and its
   gather, the block write, sorts, gathers and scatters, other torch
   kernels, copies), and the device's busy share and idle share of each
   path's unprofiled
   ms/frame.  It runs last: the profiler slows the host's launches for
   the rest of the process.
11c. cadence_profile: phase 11's group split for phase 5c's three paths
   at cadences 1, 2 and 4 (4 replayed frames each), with the traversal's
   ms by bounce segment, each named primary, sorted or stale (a profile
   that missed a traversal launch is taken again, up to 3 times).

Each phase prints its seconds; every render path must launch no probe
kernel.  The line before the last is a JSON object with each kernel's
launches in the 1080p path that runs it (phase 5 for K1, K2, G1-G6 and
the block write, phase 6 for K3, and K3's and G5's in phase 4c, phase
7's box frames for G7 and G8, phase 7b's standin-31k frames for G9), its
largest disagreement with its
plain version, both times at 2,073,600 rays, and its bound: the larger of
the bytes it must move over 3.35 TB/s and the fp32 operations this run's
rays cost it over 67 TFLOP/s (an H100 SXM's peaks); G3's two entry points
(reorder, restore) are two rows of one source, timed on the frame's own
states (the reorder's mean over the four segments; its launches count
both kernels of each of its calls, which its row gives as ``calls``, and
its ms covers both).  The last line is
``{"ok": true, "device": {...}}``.  G3's rows carry ``library_ms``: one
``torch.index_select`` computes the reorder's float gather and one
``index_copy_`` the restore's light scatter, and the block write's one
``copy_`` of the words from a host tensor.  No single PyTorch call
computes the other kernels (``library_ms`` null): each writes several
outputs of mixed types, or (G6) selects, multiplies, adds and divides;
G8's row gives the matmul sweep it replaced, many PyTorch calls, as
``matmul_sweep_ms``.  The script imports nothing of JAX.
``--out DIR`` also writes the phase-5 1080p image, downsampled 4x, as
``DIR/smoke_1080p.npy``.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT, BOUNCES = 1920, 1080, 4
N_RAYS = WIDTH * HEIGHT
TIMED_FRAMES = 8
BIG_FRAMES = 4  # timed 1080p frames of the 1,964,180-triangle scene
BIG = (700, 1400)  # its bumpy sphere's cells
BIG_TRIANGLES = 1_964_180
MULTIPART_FRAMES = 4
PROFILED_FRAMES = 4
SMALL = (96, 54)  # the frame rendered on both the card and the CPU
DEVICE = "cuda"
# phase 10's (dp, sp) meshes: __graft_entry__.dryrun_multichip:123-127's
# shapes for 2 and 4 devices, over the one card repeated
MESHES = ((2, 1), (1, 2), (2, 2), (4, 1))
SHARD_SWEEPS = 4  # timed sweeps per mesh
# the reference's default camera (opengl_raytracer_tpu/presets.py:21-22)
CAM_POS = (-33.7, 14.8, -21.1)
CAM_DIR = (65.0, -25.4)

KERNELS = {
    "subblock_traversal": dict(
        source="opengl_raytracer_torch/csrc/subblock_traversal.cu",
        replaces="opengl_raytracer_tpu/ops/subblock_traversal.py:141"),
    "shade": dict(
        source="opengl_raytracer_torch/csrc/shade.cu",
        replaces="opengl_raytracer_tpu/ops/shade.py:62"),
    "wide_traversal": dict(
        source="opengl_raytracer_torch/csrc/wide_traversal.cu",
        replaces="opengl_raytracer_tpu/ops/pallas_traversal.py:69"),
    # the main path's glue (G1-G3): JAX code that XLA fuses under jax.jit,
    # not Pallas kernels; "replaces" names the JAX lines
    "ray_front": dict(
        source="opengl_raytracer_torch/csrc/ray_front.cu",
        replaces="opengl_raytracer_tpu/renderer.py:162"),
    "sort_keys": dict(
        source="opengl_raytracer_torch/csrc/sort_keys.cu",
        replaces="opengl_raytracer_tpu/ops/morton.py:47"),
    "reorder": dict(
        source="opengl_raytracer_torch/csrc/permute.cu",
        replaces="opengl_raytracer_tpu/ops/integrator.py:209"),
    "radix_sort": dict(
        source="opengl_raytracer_torch/csrc/radix_sort.cu",
        replaces="opengl_raytracer_tpu/ops/integrator.py:209"),
    "restore": dict(
        source="opengl_raytracer_torch/csrc/permute.cu",
        replaces="opengl_raytracer_tpu/ops/integrator.py:336"),
    # the compiled step's: K3's wrapper prologue and epilogue (G5, K1's
    # entry t too), the band fold (G6), and the step block's write (the
    # JAX step's traced arguments)
    "wide_epilogue": dict(
        source="opengl_raytracer_torch/csrc/wide_epilogue.cu",
        replaces="opengl_raytracer_tpu/ops/pallas_traversal.py:270"),
    "band_fold": dict(
        source="opengl_raytracer_torch/csrc/band_fold.cu",
        replaces="opengl_raytracer_tpu/renderer.py:367"),
    "step_block": dict(
        source="opengl_raytracer_torch/csrc/step_block.cu",
        replaces="opengl_raytracer_tpu/renderer.py:495"),
    # the small-scene traversals: the "bvh" walk (G7), an XLA while loop in
    # the JAX package, and the brute-force sweep (G8), XLA matmuls there
    "bvh_walk": dict(
        source="opengl_raytracer_torch/csrc/bvh_walk.cu",
        replaces="opengl_raytracer_tpu/ops/traversal.py:56"),
    "brute_sweep": dict(
        source="opengl_raytracer_torch/csrc/brute_sweep.cu",
        replaces="opengl_raytracer_tpu/ops/intersect.py:120"),
    # the "packet" traversal (G9), an XLA while loop over [P, 128] arrays
    # in the JAX package
    "packet_walk": dict(
        source="opengl_raytracer_torch/csrc/packet_walk.cu",
        replaces="opengl_raytracer_tpu/ops/traversal.py:121"),
}
GLUE = ("ray_front", "sort_keys", "reorder", "restore", "wide_epilogue",
        "band_fold", "step_block", "bvh_walk", "brute_sweep", "packet_walk")
RADIX_LAUNCHES = 5  # G10's launches a sort: its histogram and 4 passes
# phase 3d: the sort's sizes (a frame's keys, a quarter frame's: a
# minidragon-mesh4 shard's)
RADIX_SIZES = (N_RAYS, N_RAYS // 4)
GRAPH_FRAMES = 6  # frames replayed against the eager body in phase 5b
# phase 5c: the reorder cadences (RenderConfig.sort_every) held to cadence
# 1 bit for bit, and those timed in turns (each twice, CADENCE_FRAMES a run)
CADENCES = (1, 2, 3, 4)
CADENCE_TURNS = (1, 2, 4)
CADENCE_FRAMES = 8


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


# --------------------------------------------------------------- scene

def _lat_long_grid(n_lat, n_lon):
    """Unit vectors, theta and phi on an (n_lat+1) x (n_lon+1) lat-long
    grid."""
    th = np.linspace(0.0, np.pi, n_lat + 1)
    ph = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    unit = np.stack([np.sin(T) * np.cos(P), np.cos(T), np.sin(T) * np.sin(P)],
                    axis=-1)
    return unit, T, P


def _cells(a):
    """Two triangles per cell of a grid of (..., k) values (polar cells
    included, as a UV sphere is tessellated) -> (2 * cells, 3, k)."""
    c00, c10 = a[:-1, :-1], a[1:, :-1]
    c11, c01 = a[1:, 1:], a[:-1, 1:]
    k = a.shape[-1]
    return np.concatenate([np.stack([c00, c10, c11], -2).reshape(-1, 3, k),
                           np.stack([c00, c11, c01], -2).reshape(-1, 3, k)])


def _bumpy(t, p):
    return 1.0 + 0.15 * np.sin(7 * t) * np.cos(7 * p)


def _lat_long(center, radius, n_lat, n_lon, smooth):
    """Triangles of a lat-long sphere, two per cell.  ``radius(theta, phi)``
    may vary."""
    unit, T, P = _lat_long_grid(n_lat, n_lon)
    pts = unit * radius(T, P)[..., None] + np.asarray(center, np.float64)
    tris = _cells(pts).astype(np.float32)
    normals = _cells(unit).astype(np.float32) if smooth else None
    return tris, normals


def write_lat_long_obj(path, radius, n_lat, n_lon, smooth):
    """The same sphere about the origin as an OBJ file: one ``v`` line per
    grid point, then ``f`` lines in ``_lat_long``'s triangle order; bare
    ``v`` faces, or with ``smooth`` unit ``vn`` normals and ``v//n``
    faces."""
    unit, T, P = _lat_long_grid(n_lat, n_lon)
    pts = (unit * radius(T, P)[..., None]).reshape(-1, 3)
    idx = np.arange(1, pts.shape[0] + 1).reshape(n_lat + 1, n_lon + 1, 1)
    faces = _cells(idx)[..., 0]
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in pts]
    if smooth:
        lines += [f"vn {x:.9g} {y:.9g} {z:.9g}"
                  for x, y, z in unit.reshape(-1, 3)]
        lines += [f"f {a}//{a} {b}//{b} {c}//{c}" for a, b, c in faces]
    else:
        lines += [f"f {a} {b} {c}" for a, b, c in faces]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def standin_objects(n_lat: int, n_lon: int) -> list:
    """The reference's default scene (opengl_raytracer_tpu/presets.py:25-46)
    with procedural geometry for its two OBJ meshes: a bumpy sphere of
    n_lat x n_lon cells in place of the dragon and a smooth 32 x 64 sphere
    in place of the mirror ball."""
    from opengl_raytracer_torch import Rect, Triangles

    bumpy, _ = _lat_long([-5, -10, 0], lambda t, p: 9.0 * _bumpy(t, p),
                         n_lat, n_lon, smooth=False)
    ball, ball_n = _lat_long([-25, -20, 20], lambda t, p: np.full_like(t, 7.0),
                             32, 64, smooth=True)
    return [
        Triangles(bumpy, color=(0.96, 0.96, 0.86), roughness=1),
        Triangles(ball, ball_n, color=(1, 1, 1), roughness=0),
        Rect([8, 5, 0.1], [0, 0, 30], [0, 0, 0], [1, 0.25, 0.3],
             roughness=1, scale=10),
        Rect([8, 5, 0.1], [0, 0, -30], [0, 0, 0], [0.3, 0.25, 1],
             roughness=1, scale=10),
        Rect([8, 6, 0.1], [0, -25, 0], [90, 0, 0], [0.25, 1, 0.3],
             roughness=1, scale=10),
        Rect([6, 8, 0.1], [25, 0, 0], [0, 90, 0], [0.9, 0.9, 0.9],
             roughness=0, scale=10),
        Rect([8, 6, 0.1], [0, 25, 0], [90, 0, 0], [1, 1, 1],
             roughness=1, scale=10),
        Rect([5, 5, 0.25], [0, 23.9, 0], [-90, 0, 0], [0, 0, 0],
             [1, 1, 1], 1.5, scale=5),
        Rect([6, 8, 0.1], [-35, 0, 0], [0, 90, 0], [0.9, 0.9, 0.9],
             roughness=1, scale=10),
    ]


# -------------------------------------------------------------- timing

def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` calls after one
    warm-up call, with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_pair(kernel_fn, plain_fn, iters: int, plain_iters: int):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain;
    each is the better of its two runs."""
    p1 = cuda_ms(plain_fn, plain_iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, plain_iters)
    return min(k1, k2), min(p1, p2)


def check_count(counts: dict, name: str, expected: int) -> None:
    if counts[name] != expected:
        raise RuntimeError(f"{name} launched {counts[name]} times in the "
                           f"main path, expected {expected}")


def sorts_a_raytrace(n_bounces: int, sort_every: int = 1) -> int:
    """The reorders of one raytrace at cadence ``sort_every``: before
    segment i >= 1 where (i - 1) % sort_every == 0."""
    return sum(1 for i in range(1, n_bounces) if (i - 1) % sort_every == 0)


_misses_at_reset = 0  # step.block_ahead_misses at the last reset_counts()


def _block_misses() -> int:
    from opengl_raytracer_torch.utils import profiling

    return profiling.counts().get("step.block_ahead_misses", 0)


def reset_counts() -> None:
    """Set the port's launch counts to 0, and :func:`launches`'s count of
    the steps that wrote their own block with them."""
    from opengl_raytracer_torch.ops import _kernels

    global _misses_at_reset
    _kernels.reset_counts()
    _misses_at_reset = _block_misses()


def launches() -> dict:
    """The port's launch counts since :func:`reset_counts`, and
    ``block_misses``: the renderer steps meanwhile that wrote their own
    step block, not finding it written ahead by the step before."""
    from opengl_raytracer_torch.ops import _kernels

    return dict(_kernels.launch_counts,
                block_misses=_block_misses() - _misses_at_reset)


def check_glue(counts: dict, traversal: str, n_bounces: int, renders: int,
               parts: int = 0, steps: int | None = None,
               blocks: int | None = None, sort_every: int = 1,
               folds: int | None = None) -> None:
    """The glue kernels' launches in ``renders`` chunk renders of
    ``traversal`` over ``steps`` tile steps (default: one a render): one
    ray front a render; with the reorder (the kernels' traversals) at
    cadence ``sort_every``, ``sorts_a_raytrace`` key launches, sorts (G10:
    five launches each) and reorder calls, each call two launches (index
    pass and gather), and one restore; K1's chain walking ``parts`` parts a segment; G5's entry t before each K1 or K3 segment and
    its epilogue after each K3 one; G7, G8 or G9 a segment of "bvh",
    "brute" or "packet"; ``folds`` folds (default: one a step; on a mesh,
    one a slice that a dp row's piece reaches); and ``blocks`` block writes
    (default: one a step, the next step's written ahead, and one a step
    that wrote its own, ``counts["block_misses"]`` (:func:`launches`); on
    a mesh, one a shard written ahead, one a fold, and one a shard that
    wrote its own)."""
    steps = renders if steps is None else steps
    reorder = traversal in ("packet", "pallas", "pallas2")
    sorts = sorts_a_raytrace(n_bounces, sort_every) * renders if reorder \
        else 0
    check_count(counts, "ray_front", renders)
    check_count(counts, "sort_keys", sorts)
    check_count(counts, "radix_sort", RADIX_LAUNCHES * sorts)
    check_count(counts, "reorder", 2 * sorts)
    check_count(counts, "restore", renders if reorder else 0)
    check_count(counts, "subblock_parts",
                parts * n_bounces * renders if traversal == "pallas2" else 0)
    g5 = {"pallas2": 1, "pallas": 2}.get(traversal, 0)
    check_count(counts, "wide_epilogue", g5 * n_bounces * renders)
    check_count(counts, "band_fold", steps if folds is None else folds)
    check_count(counts, "step_block",
                steps + counts["block_misses"] if blocks is None else blocks)
    check_count(counts, "bvh_walk",
                n_bounces * renders if traversal == "bvh" else 0)
    check_count(counts, "brute_sweep",
                n_bounces * renders if traversal == "brute" else 0)
    check_count(counts, "packet_walk",
                n_bounces * renders if traversal == "packet" else 0)


def check_probes(counts: dict) -> None:
    """No probe kernel launches on a render path."""
    from opengl_raytracer_torch.ops import _kernels

    for name in _kernels.PROBE_COUNTERS:
        check_count(counts, name, 0)


def timed(name: str, fn, *args):
    """Run one phase and print its seconds (a failure propagates)."""
    t0 = time.perf_counter()
    out = fn(*args)
    say(name, phase_seconds=f"{time.perf_counter() - t0:.2f}")
    return out


# -------------------------------------------------------------- phases

def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: chip_smoke.py checks the port's kernels on an "
            "NVIDIA card and has nothing to run without one")
    name = torch.cuda.get_device_name(0)
    print(card_line(), flush=True)
    say("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])
    return name


def import_port() -> None:
    sys.path.insert(0, REPO)
    try:
        import opengl_raytracer_torch  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            f"the port's package opengl_raytracer_torch is not beside "
            f"chip_smoke.py in {REPO}: {e}") from e


def ptxas_entries(log: str, unit: str, kernel: str) -> list:
    """What ``nvcc -Xptxas -v`` reported for each entry function whose name
    holds ``kernel`` (each template instance) in the unit whose section of
    ``log`` starts ``== unit``: name, registers, stack frame and spill
    bytes."""
    import re

    sec = log.split(f"== {unit}", 1)[1].split("\n== ", 1)[0]
    out = []
    for block in sec.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if kernel not in name:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", block)
        r = re.search(r"Used (\d+) registers", block)
        if not (m and r):
            raise RuntimeError(f"no ptxas properties for {name} in:\n{sec}")
        out.append(dict(name=name, registers=int(r.group(1)),
                        stack=int(m.group(1)), spill_stores=int(m.group(2)),
                        spill_loads=int(m.group(3))))
    if not out:
        raise RuntimeError(f"no ptxas entry for {kernel} in:\n{sec}")
    return out


RECON32_FLAG = "-DOGLRT_RECON_INDEX=uint32_t"
_recon32 = {}  # "lib": the 32-bit build of permute.cu, "log": nvcc's output


def build_recon32() -> None:
    """Compile ``csrc/permute.cu`` with 32-bit seed-reconstruction index
    math (``RECON32_FLAG``) into its own library under ``build/``: the
    alternative that phase 3c times against the port's 64-bit index pass.
    Its reorder takes the port's arguments."""
    import ctypes

    from opengl_raytracer_torch.ops import _kernels

    path = os.path.join(_kernels.BUILD_DIR, "liboglrt_permute_recon32.so")
    _recon32["log"] = _kernels.compile_library(
        path, [(os.path.join(REPO, "opengl_raytracer_torch", "csrc",
                             "permute.cu"), [RECON32_FLAG])])
    _recon32["lib"] = ctypes.CDLL(path)


def build_phase() -> None:
    import threading

    from opengl_raytracer_torch.ops import _kernels
    from opengl_raytracer_torch.probes import k1 as k1_probe
    from opengl_raytracer_torch.probes import k2 as k2_probe
    from opengl_raytracer_torch.probes import k3 as k3_probe

    t0 = time.perf_counter()
    errors = []
    probes = (k1_probe, k3_probe, k2_probe)

    def build_probe(build):  # each probe library, beside the kernels'
        try:
            build()
        except Exception as e:  # re-raised below, in this thread
            errors.append(e)

    threads = [threading.Thread(target=build_probe, args=(b,))
               for b in (*(m.lib for m in probes), build_recon32)]
    for th in threads:
        th.start()
    main = _kernels.lib()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    reorder32 = _recon32["lib"].oglrt_reorder
    reorder32.restype = main.oglrt_reorder.restype
    reorder32.argtypes = main.oglrt_reorder.argtypes
    sec = time.perf_counter() - t0
    say("build", seconds=f"{sec:.2f}",
        lib=os.path.relpath(_kernels.LIB_PATH, REPO),
        probe_libs=",".join(os.path.relpath(getattr(m, "PROFILE_LIB", None)
                                            or m.PROBE_LIB, REPO)
                            for m in probes),
        sources=",".join(os.path.relpath(s, REPO) for s in _kernels.sources()),
        flags="'" + " ".join(_kernels.NVCC_FLAGS) + "'")
    log = (_kernels.build_log + "".join(m.build_log for m in probes)
           + _recon32["log"])
    for line in log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or line.startswith("== ")):
            say("ptxas", line=line.strip())
    # K1's two chain kernels (one part; several) and K3's instances
    for tag, unit, kernel in (("k1", "subblock_traversal.cu",
                               "subblock_traverse"),
                              ("k3", "wide_traversal.cu",
                               "wide_traverse_kernel")):
        entries = ptxas_entries(_kernels.build_log, unit, kernel)
        if tag == "k1" and len(entries) != 2:
            raise RuntimeError(f"K1: {len(entries)} ptxas entries, expected "
                               f"the chain kernels of one part and of "
                               f"several")
        for props in entries:
            say("ptxas", **{tag: props})
            if (props["spill_stores"] or props["spill_loads"]
                    or props["stack"] >= 64):
                raise RuntimeError(f"{tag.upper()} spills or keeps a stack "
                                   f"frame of 64 bytes or more: {props}")
            if tag == "k1" and props["registers"] > K1_REGISTERS:
                raise RuntimeError(f"K1 uses more than {K1_REGISTERS} "
                                   f"registers: {props}")
    for tag, unit, kernel in (("g7", "bvh_walk.cu", "bvh_walk_kernel"),
                              ("g8", "brute_sweep.cu", "brute_sweep_kernel"),
                              ("g9", "packet_walk.cu", "packet_walk_kernel")):
        for props in ptxas_entries(_kernels.build_log, unit, kernel):
            say("ptxas", **{tag: props})
    for tag, log in (("index_pass_i64", _kernels.build_log),
                     ("index_pass_u32", _recon32["log"])):
        for props in ptxas_entries(log, "permute.cu", "reorder_index_kernel"):
            say("ptxas", **{tag: props})


def make_scene(n_lat: int, n_lon: int, device):
    """The stand-in scene with an n_lat x n_lon bumpy sphere, its tables
    and its upload; prints the host's seconds for each."""
    from opengl_raytracer_torch import Scene
    from opengl_raytracer_torch.ops import bvh

    t0 = time.perf_counter()
    scene = Scene(standin_objects(n_lat, n_lon))
    t1 = time.perf_counter()
    scene.fields()
    t2 = time.perf_counter()
    data = scene.send(device)
    if data.device.type == "cuda":
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    say("scene", triangles=scene.total_triangles,
        parts=len(data.k1_parts),
        k1_table_bytes=sum(n.nbytes + o.nbytes for n, o, _ in data.k1_parts),
        k3_table_bytes=sum(x.nbytes for x in data.k3),
        pw_max_stack=data.pw_max_stack, sh_slot_bytes=data.sh_slot.nbytes,
        bvh_builder=bvh.last_builder, bvh_s=f"{t1 - t0:.2f}",
        tables_s=f"{t2 - t1:.2f}", upload_s=f"{t3 - t2:.2f}",
        build_s=f"{t3 - t0:.2f}")
    return scene, data


# Each kernel's bound: the larger of the bytes it must move (each input
# read once, each output written once) over the card's memory rate and its
# fp32 operations over the card's fp32 rate, each mul, add, sub, min, max,
# compare, reciprocal or division counted as 1.  An H100 SXM's peaks (data
# sheet): HBM3, and fp32 outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# A traversal's rays (K1, K3): 7 f32 columns in; t, slot, u, v out.
TRAVERSAL_BYTES_PER_RAY = 44
# K1's chain resolves its hits: tri out too (its remap read, the table
# counted once)
K1_BYTES_PER_RAY = TRAVERSAL_BYTES_PER_RAY + 4
# 8 blocks of 128 threads an SM: a cap below spilled and ran slower
K1_REGISTERS = 64
# K1's operations, as csrc/subblock_traversal.cu does them, from the plain
# version's counts of this run's rays (probes/k1.work):
K1_OPS_PER_RAY = 12  # 3 reciprocals, 6 clamps, 3 products o * inv
K1_OPS_PER_NODE = 8 * 25  # per child: 6 mul, 6 sub, 10 min/max, 3 compares
K1_OPS_PER_OCTET = 8 * 20  # per triangle: det 5, |det| test 2, 1/det 1,
#                            r 3, t 7, the t tests 2
K1_OPS_PER_CANDIDATE = 26  # a triangle whose t beats the best hit: p 9,
#                            u 7, v 6, the barycentric tests 4
# K2's work per ray (csrc/shade.cu): 73 bytes in (t, u, v, o, d, ray color,
# incoming light, slot, alive, seed), 57 out, and the material table read
# once; about 180 fp32 operations (normal, scatter, update, three draws).
K2_BYTES_PER_RAY = 130
K2_OPS_PER_RAY = 180
# K3's operations (csrc/wide_traversal.cu), from its plain version's counts
# (probes/k3.work): per ray 3 reciprocals; per node visit 8 slab tests of 26
# (K1's 25 and the clamp of near at 0); per triangle tested (each leaf's
# own), as the kernel tests it (t first), K1's 20, and per candidate K1's
# 26.  Before the t-first test a triangle was priced at a full test of 47
# (K1's 46 and the octet's argmin), printed beside it as the earlier
# yardstick.
K3_OPS_PER_RAY = 3
K3_OPS_PER_NODE = 8 * 26
K3_OPS_PER_SLOT = K1_OPS_PER_OCTET // 8
K3_OPS_PER_CANDIDATE = K1_OPS_PER_CANDIDATE
K3_OPS_PER_SLOT_FULL = 47


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card takes to move ``n_bytes`` and do ``n_ops``
    fp32 operations, and which of the two bounds it."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_FP32 * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_bound(w: dict, k1) -> tuple[int, int, float, str]:
    """K1's operations and bytes for the ray set whose counts ``w`` holds
    (``probes/k1.work``), over the part's tables ``k1`` (Hopper nodes and
    octets, remap), and the bound they give."""
    ops = (w["live"] * K1_OPS_PER_RAY + w["visits"] * K1_OPS_PER_NODE
           + w["octets"] * K1_OPS_PER_OCTET
           + w["candidates"] * K1_OPS_PER_CANDIDATE)
    n_bytes = (w["rays"] * K1_BYTES_PER_RAY
               + sum(x.numel() * x.element_size() for x in k1))
    return (ops, n_bytes, *bound_ms(n_bytes, ops))


def k2_phase(data, seed: int, device):
    """K2 against its plain version; returns (max_abs_err, ms, plain_ms,
    (bound_ms, bound_by))."""
    from opengl_raytracer_torch import make_camera
    from opengl_raytracer_torch.ops import shade, step_block
    from opengl_raytracer_torch.ops.intersect import BIG, Nearest

    R = N_RAYS
    g = np.random.default_rng(seed)
    f32 = np.float32
    t = g.uniform(0.1, 80.0, R).astype(f32)
    t[g.uniform(size=R) < 0.2] = BIG  # misses
    u = g.uniform(0, 1, R).astype(f32)
    v = (g.uniform(0, 1, R) * (1 - u)).astype(f32)
    d = g.normal(size=(3, R))
    d /= np.linalg.norm(d, axis=0, keepdims=True)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def col3(a):
        return tuple(dev(a[k]) for k in range(3))

    near = Nearest(t=dev(t), tri=torch.zeros(R, dtype=torch.int32,
                                              device=device),
                   u=dev(u), v=dev(v),
                   slot=dev(g.integers(0, data.sh_slot.shape[0], R)
                            .astype(np.int32)))
    o3 = col3(g.uniform(-30, 30, (3, R)).astype(f32))
    d3 = col3(d.astype(f32))
    rc3 = col3(g.uniform(0, 1, (3, R)).astype(f32))
    inc3 = col3(g.uniform(0, 1, (3, R)).astype(f32))
    alive = dev(g.uniform(size=R) < 0.8)
    seeds = dev(g.integers(0, 2**32, R, dtype=np.uint64).astype(np.int64))

    def block(lam):  # the step block K2 reads its sky and mode from
        b = step_block.new(device)
        step_block.write_plain(b, step_block.pack(
            0, (0,) * 5, make_camera(CAM_POS, CAM_DIR), 1.0, 0.0, lam))
        return b

    worst = 0.0
    for lam in (True, False):
        args = (data.sh_slot, near.slot, near, o3, d3, rc3, inc3, alive,
                seeds, block(lam))
        got = shade.shade_update(*args)  # CUDA tensors: the kernel
        ref = shade._shade_plain(*args)
        for gk, rk in zip(got[:4], ref[:4]):
            for a in range(3):
                torch.testing.assert_close(gk[a], rk[a], rtol=1e-5, atol=1e-6)
                worst = max(worst, float((gk[a] - rk[a]).abs().max()))
        if not torch.equal(got[4], ref[4]):
            raise RuntimeError("K2: alive differs from the plain version")
        if not torch.equal(got[5], ref[5]):
            raise RuntimeError("K2: seed differs from the plain version")
        say("k2", lambertian=lam, rays=R, alive_out=int(got[4].sum()),
            max_abs_err=worst, seed_alive="exact")

    args = (data.sh_slot, near.slot, near, o3, d3, rc3, inc3, alive, seeds,
            block(True))
    ms, plain_ms = time_pair(lambda: shade.shade_update(*args),
                             lambda: shade._shade_plain(*args), 20, 5)
    bound = bound_ms(R * K2_BYTES_PER_RAY + data.sh_slot.nbytes,
                     R * K2_OPS_PER_RAY)
    say("k2", rays=R, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
        bound_by=bound[1], share_of_bound=bound[0] / ms,
        tolerance="rtol=1e-5,atol=1e-6")
    return worst, ms, plain_ms, bound


def k1_rays(data, camera, seed: int, device):
    """Half primary rays of the 1080p camera, half bounce-like rays from
    random points in the scene's bounds; a tenth of the rays dead."""
    from opengl_raytracer_torch.ops.camera import pixel_uv, ray_dirs_soa
    from opengl_raytracer_torch.ops.intersect import BIG

    g = np.random.default_rng(seed + 1)
    half = N_RAYS // 2
    pix = torch.from_numpy(g.integers(0, N_RAYS, half))
    u, v = pixel_uv(pix % WIDTH, pix // WIDTH, WIDTH, HEIGHT)
    dp = torch.stack(ray_dirs_soa(camera, u, v, WIDTH, HEIGHT)).numpy()
    op = np.repeat(np.asarray(camera.pos, np.float32)[:, None], half, 1)
    nb = N_RAYS - half
    ob = g.uniform(data.root_min, data.root_max, (nb, 3)).T
    db = g.normal(size=(3, nb))
    db /= np.linalg.norm(db, axis=0, keepdims=True)
    o = np.concatenate([op, ob], 1).astype(np.float32)
    d = np.concatenate([dp, db], 1).astype(np.float32)
    t0 = np.full(N_RAYS, BIG, np.float32)
    t0[g.uniform(size=N_RAYS) < 0.1] = -BIG
    o3 = tuple(torch.from_numpy(o[a].copy()).to(device) for a in range(3))
    d3 = tuple(torch.from_numpy(d[a].copy()).to(device) for a in range(3))
    return o3, d3, torch.from_numpy(t0).to(device)


def eager_render(r, camera, frames: int = 1, state=None):
    """``frames`` sweeps of Renderer ``r`` with each step's body run
    eagerly (``Renderer._step_eager``), so a wrapper put around one of its
    entry points sees every call; a replayed graph would pass none."""
    state = r.init_state() if state is None else state
    cfg = r.config
    tiles = cfg.num_tiles_x * cfg.num_tiles_y
    for _ in range(frames // cfg.frames_per_step * tiles):
        state = r._step_eager(state, camera)
    return state


def frame_segments(scene, camera, traversal: str = "auto",
                   expect: str = "pallas2", sort_every: int = 1):
    """The five bounce segments of one 1920x1080 frame of ``traversal``
    (which must resolve to ``expect``) at reorder cadence ``sort_every``,
    each as ``raytrace`` hands it to the traversal (after the reorder sort,
    where one ran): (o3, d3, t0) with t0 = BIG for a live ray and -BIG for
    a dead one, the entry the first part gets."""
    from opengl_raytracer_torch import RenderConfig, Renderer
    from opengl_raytracer_torch.ops.intersect import BIG

    r = Renderer(scene, RenderConfig(width=WIDTH, height=HEIGHT,
                                     bounces=BOUNCES, traversal=traversal,
                                     sort_every=sort_every),
                 device=DEVICE)
    if r.traversal != expect:
        raise RuntimeError(f"{traversal} resolved to {r.traversal}, not "
                           f"{expect}")
    segments = []
    traverse = r._raycast

    def record(o3, d3, active=None):
        t0 = torch.where(active, BIG, -BIG).to(torch.float32)
        segments.append((tuple(x.clone() for x in o3),
                         tuple(x.clone() for x in d3), t0))
        return traverse(o3, d3, active)

    r._raycast = record
    eager_render(r, camera)
    torch.cuda.synchronize()
    if len(segments) != r.config.n_bounces:
        raise RuntimeError(f"captured {len(segments)} segments")
    return segments


def _k1_chain_checked(label, data, o3, d3, t0):
    """The main path's K1 launch (``traverse_parts``) on one ray set,
    against its plain version (``_chain_plain``): t, tri, u, v and slot bit
    for bit, one launch walking the scene's parts, no stack overflow.
    Returns the kernel's ``Nearest`` and the plain chain's per-ray work
    (``_traverse_plain``'s counts, summed over the parts)."""
    from opengl_raytracer_torch.ops import _kernels
    from opengl_raytracer_torch.ops import subblock_traversal as sbt

    ov = sbt.overflow_tensor(t0.device)
    ov.zero_()
    before = dict(_kernels.launch_counts)
    kernel = sbt.traverse_parts(data, o3, d3, t0)
    if (_kernels.launch_counts["subblock_traversal"]
            - before["subblock_traversal"] != 1
            or _kernels.launch_counts["subblock_parts"]
            - before["subblock_parts"] != len(data.k1_parts)):
        raise RuntimeError(f"K1 on {label}: not one launch walking "
                           f"{len(data.k1_parts)} parts")
    plain, dropped, counts = sbt._chain_plain(data.k1_parts, o3, d3, t0,
                                              counts=True)
    overflow = int(ov.item())
    if overflow or int(dropped):
        raise RuntimeError(f"K1 stack overflow on {label}: kernel "
                           f"{overflow} group pushes, plain "
                           f"{int(dropped)} pushes dropped")
    for field, a, b in zip(kernel._fields, kernel, plain):
        if not torch.equal(a, b):
            diff = (a.double() - b.double()).abs().max()
            raise RuntimeError(f"K1 {field} differs from the plain "
                               f"version on {label}: max |d| {diff}")
    return kernel, counts


def k1_phase(data, camera, segments, seed: int, device):
    """K1 as the main path launches it (the chain kernel of the scene's
    one part) against its plain version on phase 3's rays and on the
    frame's segments; returns (max_abs_err, ms, plain_ms, (bound_ms,
    bound_by), frame_ms, the ray sets)."""
    from opengl_raytracer_torch.ops import subblock_traversal as sbt
    from opengl_raytracer_torch.ops.intersect import BIG
    from opengl_raytracer_torch.probes import k1 as k1_probe

    k1 = data.k1_parts[0]
    sets = [("random", *k1_rays(data, camera, seed, device))]
    sets += [(f"frame_b{i}", *seg) for i, seg in enumerate(segments)]
    frame_ms, out = 0.0, None
    for name, o3, d3, t0 in sets:
        kernel, counts = _k1_chain_checked(name, data, o3, d3, t0)
        hit = int((kernel.t < BIG).sum())
        w = k1_probe.work(counts, t0)
        ops, n_bytes, bound, by = k1_bound(w, k1)
        if name == "random" and hit < N_RAYS // 4:
            raise RuntimeError(f"K1: only {hit} of {N_RAYS} rays hit")
        ms = cuda_ms(lambda: sbt.traverse_parts(data, o3, d3, t0), 10)
        say("k1", set=name, rays=w["rays"], live=w["live"], hit=hit,
            max_abs_err=0.0, tri_ties=0, overflow=0, ms=ms,
            visits_per_ray=round(w["visits_per_ray"], 3),
            octets_per_ray=round(w["octets_per_ray"], 3),
            steps_per_ray=round(w["steps_per_ray"], 3),
            candidates_per_ray=round(w["candidates_per_ray"], 3),
            lanes_steps=round(w["lanes_steps"], 4),
            lanes_visits=round(w["lanes_visits"], 4),
            lanes_octets=round(w["lanes_octets"], 4),
            gops=round(ops / 1e9, 4), mbytes=round(n_bytes / 1e6, 3),
            bound_ms=round(bound, 5), bound_by=by,
            share_of_bound=round(bound / ms, 4))
        if name == "random":
            plain_ms = min(cuda_ms(lambda: sbt._chain_plain(
                data.k1_parts, o3, d3, t0), 1) for _ in range(2))
            out = (ms, plain_ms, (bound, by))
        else:
            frame_ms += ms
    say("k1", frame_ms=frame_ms, segments=len(segments),
        tolerance="exact (t, tri, u, v, slot bit for bit)")
    return 0.0, *out, frame_ms, sets


def k1prof_phase(data, sets):
    """The K1 profile build on phase 3's ray sets: its raw hits and its
    visit, octet and edge-load counts against the plain walk's, and the
    cycles of each stage."""
    from opengl_raytracer_torch.ops import _kernels
    from opengl_raytracer_torch.ops import subblock_traversal as sbt
    from opengl_raytracer_torch.probes import k1 as k1_probe

    k1 = data.k1_parts[0]
    frame = dict.fromkeys(k1_probe.STAGES + k1_probe.EVENTS, 0)
    before = dict(_kernels.launch_counts)
    for name, o3, d3, t0 in sets:
        hits, stages = k1_probe.profile(k1, o3, d3, t0)
        *plain, _, counts = sbt._traverse_plain(*k1[:2], o3, d3, t0,
                                                counts=True)
        if not all(torch.equal(a, b) for a, b in zip(hits, plain)):
            raise RuntimeError(f"K1 profile build differs from the plain "
                               f"walk on {name}")
        for ev, row in (("visits", 0), ("octets", 1), ("edge_loads", 3)):
            if stages[ev] != int(counts[row].long().sum()):
                raise RuntimeError(f"K1 profile {ev} {stages[ev]} on {name}, "
                                   f"plain {int(counts[row].long().sum())}")
        if name.startswith("frame"):
            for k in frame:
                frame[k] += stages[k]
        else:
            _say_stages(name, k1_probe.stage_report(stages))
    _say_stages("frame", k1_probe.stage_report(frame))
    _, o3, d3, t0 = sets[0]
    iters = 3
    say("k1prof", set=sets[0][0], profile_ms=cuda_ms(
        lambda: k1_probe.profile(k1, o3, d3, t0), iters))
    launched = _kernels.launch_counts["k1_profile"] - before["k1_profile"]
    if launched != len(sets) + iters + 1:
        raise RuntimeError(f"k1_profile launched {launched} times")


def _say_stages(name, rep):
    say("k1prof", set=name, **{
        s: f"{rep[s]['share']:.3f}/{rep[s]['per_event']:.1f}"
           + (f"/{rep[s]['per_unit']:.1f}" if "per_unit" in rep[s] else "")
        for s in rep if s != "events"}, events=rep["events"],
        key="share/cycles-per-event[/per-16B-load-or-triangle]")


# The glue kernels' work per ray (csrc/ray_front.cu, sort_keys.cu,
# permute.cu): bytes each input read once and each
# output written once; integer and fp32 operations, each counted as 1
# against the fp32 rate.  G1: px, py, a frame number (int64) in, six float
# columns and a seed out; seed, warm-ups, two draws, uv, direction, jitter,
# two normalizes.  G2: six float columns and a flag in, an int32 key out;
# three quantized coordinates, five direction levels, the Morton spread.
# G3: see g3_reorder_work and g3_restore_work.
G1_BYTES_PER_RAY = 32  # writes only: the pixel comes from the index
G1_OPS_PER_RAY = 95  # with the pixel and frame from the index
# G5 (csrc/wide_epilogue.cu), one bounce: the prologue reads a flag and
# writes t0; the epilogue reads t, slot, u, v (the remap table counted
# once) and writes t, tri, u, v.  G6 (csrc/band_fold.cu) per band pixel at
# one frame a step: 3 colours and 3 accum values read, 3 written; a sum,
# product and quotient a channel
G5_BYTES_PER_RAY = 5 + 16 + 16
G5_OPS_PER_RAY = 8
G6_BYTES_PER_PIXEL = 12 + 12 + 12
G6_OPS_PER_PIXEL = 9
# G7 (csrc/bvh_walk.cu): per node visit of a live ray 6 sub, 6 mul, 10
# min/max and 4 compares; per triangle test its t side (det 5, 1/det 1, r
# 3, t 7, the t tests 4) and per candidate (a test whose t would win) p 9,
# u 7, v 6 and the barycentric tests 4.  The earlier yardstick, printed
# beside it as bound_ms_full_tests, priced every visit, a dead ray's miss
# links too, and a full test of 45 at every test.  Bytes: 7 ray columns in, t, tri, u, v out, the node and
# triangle records once.
G7_OPS_PER_VISIT = 26
G7_OPS_PER_TEST = 20
G7_OPS_PER_CANDIDATE = 26
G7_OPS_PER_TEST_FULL = 45
RAY_IN_OUT_BYTES = 29 + 16
# G8 (csrc/brute_sweep.cu): per live ray o x d, 9; per (live ray,
# triangle) pair det 5, the |det| test 2, 1/det 1, o.face 5, t 2, the t
# tests 2; per candidate (a pair whose t would win) the four dot products
# 20, 2 sub, 2 mul and the barycentric tests 4.  Bytes: the ray columns as
# G7's and the 48-byte triangle records once.
G8_OPS_PER_RAY = 9
G8_OPS_PER_PAIR = 17
G8_OPS_PER_CANDIDATE = 28
G2_BYTES_PER_RAY = 29
G2_OPS_PER_RAY = 90
# G3 before the fold (the earlier yardstick, printed beside the new one):
# every ray read an int64 index, a key, 12 columns, a seed and an int64
# index and wrote 12 columns, a seed, an index and a flag; the restore
# moved 3 columns, a seed and an index in and 3 columns and a seed out.
G3_UNFOLDED_REORDER_BYTES_PER_RAY = 8 + 4 + 48 + 8 + 8 + 48 + 8 + 8 + 1
G3_UNFOLDED_RESTORE_BYTES_PER_RAY = 8 + 12 + 8 + 12 + 8


def g3_reorder_work(alive, return_seed: bool,
                    recon: bool = False) -> tuple[int, int]:
    """(bytes, scattered 32-byte sectors) of one reorder whose sorted rays
    are live where ``alive``: every ray reads its int32 index (G10's
    permutation), sorted key and int32 original index, and writes 12 columns, a seed, an index and a
    flag; a live ray reads 9 columns and its seed (not with ``recon``,
    which reads the 128-byte step block once instead), a dead ray 3
    columns (and its seed with ``return_seed``).  Each read by the permuted
    index is one scattered sector: 11 for a live ray (10 with ``recon``),
    4 (5) for a dead one."""
    n = alive.numel()
    live = int(alive.sum())
    dead = n - live
    seed = 8 if return_seed else 0
    n_bytes = (n * (4 + 4 + 4 + 48 + 8 + 4 + 1)
               + live * (36 + (0 if recon else 8)) + dead * (12 + seed)
               + (128 if recon else 0))
    return n_bytes, live * (10 if recon else 11) + dead * (
        4 + (1 if return_seed else 0))


def g3_restore_work(n: int, with_seed: bool) -> tuple[int, int]:
    """(bytes, scattered sectors) of one restore of ``n`` rays: 3 columns
    and an int32 index in, 3 columns out, each write scattered; 16 bytes
    and a sector more with the seed."""
    return n * (28 + (16 if with_seed else 0)), n * (4 if with_seed else 3)


def _glue_row(name, err, ms, plain_ms, n_bytes, n_ops, **extra):
    bound, by = bound_ms(n_bytes, n_ops)
    say("glue", kernel=name, rays=N_RAYS, ms=ms, plain_ms=plain_ms,
        mbytes=round(n_bytes / 1e6, 3), bound_ms=bound, bound_by=by,
        share_of_bound=bound / ms, max_abs_err=err, tolerance="exact",
        **extra)
    return err, ms, plain_ms, (bound, by)


def _assert_equal(name, got, ref, bits: bool = False) -> float:
    """Every tensor of ``got`` equals ``ref``'s (nested tuples), dtype and
    value (with ``bits``, byte for byte: +0.0 is not -0.0); returns the
    largest |difference| over them (0.0)."""
    def flat(x):
        if isinstance(x, (tuple, list)):
            return [y for z in x for y in flat(z)]
        return [] if x is None else [x]

    def same(a, b):
        if bits:
            return torch.equal(a.contiguous().view(torch.uint8),
                               b.contiguous().view(torch.uint8))
        return torch.equal(a, b)

    g, r = flat(got), flat(ref)
    if len(g) != len(r):
        raise RuntimeError(f"{name}: {len(g)} outputs, plain {len(r)}")
    for k, (a, b) in enumerate(zip(g, r)):
        if a.dtype != b.dtype or a.shape != b.shape or not same(a, b):
            diff = (a.double() - b.double()).abs().max() \
                if a.shape == b.shape else "shape"
            raise RuntimeError(f"{name}: output {k} differs from the plain "
                               f"version ({a.dtype} vs {b.dtype}, max |d| "
                               f"{diff})")
    return max((float((a.double() - b.double()).abs().max())
                for a, b in zip(g, r) if a.numel()), default=0.0)


def glue_phase(data, camera, sets, seed: int, packet_segments):
    """G1-G9 against their plain versions on the card at 2,073,600 rays,
    bit for bit; their ms per launch, the plain versions' and the bound.
    ``packet_segments``: the five bounce segments of a 1080p "packet"
    frame of standin-31k, for G9.
    Returns ({counter: (max_abs_err, ms, plain_ms, (bound_ms, bound_by))},
    {counter: more keys of its row in the kernels line})."""
    from opengl_raytracer_torch.ops import front, morton, permute, radix_sort
    from opengl_raytracer_torch.ops.intersect import BIG

    out, extras = {}, {}
    dev = data.device
    before = dict(_kernels_counts())

    # G1: a quarter of the 1080p frame's rows with frames_per_step = 4 at
    # frame numbers that wrap past 2^32; then the whole frame at 2^32 - 1
    quarter = make_block(dev, camera, 2**32 - 2, (0, HEIGHT // 4, 0, 0, 0))
    whole = make_block(dev, camera, 2**32 - 1, (0, 0, 0, 0, 0))
    g1 = [(quarter, 0, N_RAYS, N_RAYS, N_RAYS // 4, WIDTH),
          (whole, 0, N_RAYS, N_RAYS, N_RAYS, WIDTH)]
    err = 0.0
    for args in g1:
        args = (*args, WIDTH, HEIGHT, None)
        err = max(err, _assert_equal("G1", front.ray_front(*args),
                                     front.ray_front_plain(*args)))
    # and in the "packet" traversal's 8x16 block order: the whole frame,
    # once and as frames_per_step 2
    err_blocks = 0.0
    for F in (2, 1):
        args = (whole, 0, F * N_RAYS, F * N_RAYS, N_RAYS, WIDTH, WIDTH,
                HEIGHT, None, True)
        err_blocks = max(err_blocks, _assert_equal(
            f"G1 blocks F={F}", front.ray_front(*args),
            front.ray_front_plain(*args)))
    ms_blocks = min(cuda_ms(lambda: front.ray_front(*args), 20)
                    for _ in range(2))
    args = (*g1[0], WIDTH, HEIGHT, None)
    ms, plain_ms = time_pair(lambda: front.ray_front(*args),
                             lambda: front.ray_front_plain(*args), 20, 3)
    extras["ray_front"] = dict(blocks_max_abs_err=err_blocks,
                               blocks_ms=ms_blocks)
    out["ray_front"] = _glue_row("ray_front", max(err, err_blocks), ms,
                                 plain_ms, N_RAYS * G1_BYTES_PER_RAY,
                                 N_RAYS * G1_OPS_PER_RAY, frames_per_step=4,
                                 first_frame=2**32 - 2,
                                 **extras["ray_front"])

    # G2: phase 3's ray sets; the random one also with out-of-box
    # origins, NaN and +-inf in its columns
    lo, hi = data.root_min, data.root_max
    g = np.random.default_rng(seed + 7)
    _, o3, d3, t0 = sets[0]
    odd_o = [x.clone() for x in o3]
    odd_d = [x.clone() for x in d3]
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30,
                            -1e30, 0.0], device=dev)
    # 3,000 odd values in each column of o and of d
    n_odd, n_far = min(500, N_RAYS // 24), min(20000, N_RAYS // 4)
    for a in range(3):
        idx = torch.from_numpy(g.choice(N_RAYS, 12 * n_odd, replace=False)
                               ).to(dev)
        odd_o[a][idx[:6 * n_odd]] = special.repeat(n_odd)
        odd_d[a][idx[6 * n_odd:]] = special.repeat(n_odd)
        far = torch.from_numpy(g.choice(N_RAYS, n_far, replace=False)).to(dev)
        odd_o[a][far] = torch.from_numpy(g.uniform(-1e4, 1e4, n_far)
                                         .astype(np.float32)).to(dev)
    key_sets = [(tuple(odd_o), tuple(odd_d), t0 > -BIG)]
    key_sets += [(s[1], s[2], s[3] > -BIG) for s in sets]
    err = max(_assert_equal("G2", morton.sort_keys(o, d, lo, hi, alive),
                            morton.sort_keys_i32_plain(o, d, lo, hi, alive))
              for o, d, alive in key_sets)
    o, d, alive = key_sets[1]
    ms, plain_ms = time_pair(
        lambda: morton.sort_keys(o, d, lo, hi, alive),
        lambda: morton.sort_keys_i32_plain(o, d, lo, hi, alive), 20, 3)
    keys32 = morton.sort_keys(o, d, lo, hi, alive)
    keys64 = morton.ray_sort_keys_soa(o, d, lo, hi, alive)
    if not torch.equal(torch.argsort(keys32, stable=True),
                       torch.argsort(keys64, stable=True)):
        raise RuntimeError("G2: the int32 keys sort unlike the uint32 keys")
    sort32, sort64 = time_pair(lambda: torch.argsort(keys32, stable=True),
                               lambda: torch.argsort(keys64, stable=True),
                               10, 10)
    out["sort_keys"] = _glue_row("sort_keys", err, ms, plain_ms,
                                 N_RAYS * G2_BYTES_PER_RAY,
                                 N_RAYS * G2_OPS_PER_RAY,
                                 argsort_int32_ms=sort32,
                                 argsort_int64_ms=sort64)

    # G3 (a): 12 random columns, ~30% of the rays dead and a live ray's
    # light +0.0, on a random permutation (dead rays scattered) and on the
    # stable sort of the frame's primary rays' keys (dead rays at the
    # tail); (b) the four pre-reorder states and the restore of one 1080p
    # "auto" frame; (c) each with return_seed on and off
    dead = torch.from_numpy(g.uniform(size=N_RAYS) < 0.3).to(dev)
    cols = [torch.from_numpy(g.normal(size=N_RAYS).astype(np.float32))
            .to(dev) for _ in range(12)]
    for c in cols[9:]:
        c[~dead] = 0.0
    groups = tuple(tuple(cols[3 * k:3 * k + 3]) for k in range(4))
    seeds = torch.from_numpy(g.integers(0, 2**32, N_RAYS)).to(dev)
    orig = torch.arange(N_RAYS, dtype=torch.int32, device=dev)
    o, d, _ = key_sets[2]
    keys_f = morton.sort_keys(o, d, lo, hi, ~dead)
    perm_r = torch.from_numpy(g.permutation(N_RAYS).astype(np.int32)).to(dev)
    states = [("random", (keys_f[perm_r.long()], perm_r, *groups, seeds,
                          orig)),
              ("sorted", (*radix_sort.sort_rays(keys_f), *groups, seeds,
                          orig))]
    frame, restores = frame_states(data, camera)
    restore_in = restores[0]
    states += [(f"frame_b{k + 1}", st) for k, (st, _, _) in enumerate(frame)]
    recons = {f"frame_b{k + 1}": (rc, dr)
              for k, (_, rc, dr) in enumerate(frame)}
    errs = [0.0, 0.0]
    for name, st in states:
        for k, e in enumerate(_g3_check(name, st)):
            errs[k] = max(errs[k], e)
        if name.startswith("frame"):
            _g3_live_light(name, st)
        else:  # from pixel order and back
            fwd = permute.reorder(*st)
            _assert_equal("G3 identity", permute.restore(*fwd[3:4], *fwd[5:]),
                          (groups[3], seeds), bits=True)
    errs[1] = max(errs[1], _assert_equal(
        "G3 restore frame", permute.restore(*restore_in),
        permute.restore_plain(*restore_in), bits=True))
    errs[0] = max(errs[0], _g3_recon_check(data, camera, frame))
    rows = {name: _g3_times(name, st, recons.get(name))
            for name, st in states}
    frame_rows = [rows[name] for name, _ in states[2:]]
    reorder_ms, plain_ms, library_ms, n_bytes, extra = _g3_mean(frame_rows)
    extra.update(_g3_index_widths(frame))
    extra.update({f"{k}_{tag}_perm": rows[tag][k] for tag in ("random",
                                                             "sorted")
                  for k in ("ms", "library_ms")})
    out["reorder"] = _glue_row("reorder", errs[0], reorder_ms, plain_ms,
                               n_bytes, 0, set="frame_b1-4 (mean)",
                               return_seed=False, seed_recon=True,
                               library_ms=library_ms, **extra)
    extras["reorder"] = dict(library_ms=library_ms, seed_recon=True, **extra)
    restore_row = _g3_restore_times(*restore_in)
    out["restore"] = _glue_row("restore", errs[1], *restore_row[:2],
                               restore_row[3], 0, set="frame",
                               library_ms=restore_row[2], **restore_row[4])
    extras["restore"] = dict(library_ms=restore_row[2], **restore_row[4])

    out["wide_epilogue"] = _g5_rows(data, sets)
    out["band_fold"], extras["band_fold"] = _g6_rows(dev, camera, seed)
    out["step_block"], extras["step_block"] = _block_rows(dev, camera)
    out["bvh_walk"], extras["bvh_walk"] = _g7_rows(camera, seed, data)
    out["brute_sweep"], extras["brute_sweep"] = _g8_rows(camera, seed)
    out["packet_walk"], extras["packet_walk"] = _g9_rows(camera, seed, data,
                                                         packet_segments)
    launched = {k: v - before[k] for k, v in _kernels_counts().items()}
    if any(launched[k] == 0 for k in out):
        raise RuntimeError(f"glue kernels launched {launched}")
    check_probes(launched)
    say("glue", sets=len(sets), key_sets=len(key_sets), g3_sets=len(states),
        card=repr(card_line()))
    return out, extras


def make_block(device, camera, frame, window, lambertian=True, sky=1.0,
               jitter=0.05, accum=None):
    """A step block on ``device`` holding these values (its plain write)."""
    from opengl_raytracer_torch.ops import step_block

    block = step_block.new(device)
    step_block.write_plain(block, step_block.pack(
        frame, window, camera, sky, jitter, lambertian,
        0 if accum is None else accum.data_ptr()))
    return block


def _g5_rows(data, sets):
    """G5, K3's prologue and epilogue, against their plain versions bit
    for bit on K3's own output for phase 3's ray sets (with their dead
    rays); timed as one bounce's pair of launches on the random set."""
    from opengl_raytracer_torch.ops import pallas_traversal as wide
    from opengl_raytracer_torch.ops.intersect import BIG

    remap, dev, err = data.pl_remap, data.device, 0.0
    for name, o3, d3, t0 in sets:
        active = t0 > -BIG
        got_t0 = wide.wide_prologue(active, N_RAYS, dev)
        err = max(err, _assert_equal(f"G5 prologue {name}", got_t0,
                                     wide._prologue_plain(active, N_RAYS,
                                                          dev)))
        k3 = wide.traverse_wide(data, o3, d3, got_t0)
        err = max(err, _assert_equal(
            f"G5 epilogue {name}", tuple(wide.wide_epilogue(*k3, remap)[:4]),
            tuple(wide._epilogue_plain(*k3, remap)[:4])))
    _, o3, d3, t0 = sets[0]
    active = t0 > -BIG
    k3 = wide.traverse_wide(data, o3, d3, t0)

    def kernel():
        wide.wide_prologue(active, N_RAYS, dev)
        wide.wide_epilogue(*k3, remap)

    def plain():
        wide._prologue_plain(active, N_RAYS, dev)
        wide._epilogue_plain(*k3, remap)

    ms, plain_ms = time_pair(kernel, plain, 20, 3)
    n_bytes = N_RAYS * G5_BYTES_PER_RAY + remap.numel() * remap.element_size()
    return _glue_row("wide_epilogue", err, ms, plain_ms, n_bytes,
                     N_RAYS * G5_OPS_PER_RAY, launches_a_call=2,
                     set="random (prologue + epilogue)")


def _g6_rows(dev, camera, seed):
    """G6, the band fold, against its plain version bit for bit: the whole
    1080p frame as one band (the main path's) at frame 2^32 - 2, three
    tiles of tile_size 7 (remainders along both axes) with
    frames_per_step 2 at frame 2^24 + 1, and the whole frame in the
    "packet" traversal's 8x16 block order at frames_per_step 1 and 2;
    timed on the whole frame, row-major and in blocks."""
    from opengl_raytracer_torch import RenderConfig
    from opengl_raytracer_torch.ops import fold, step_block
    from opengl_raytracer_torch.renderer import step_words

    g = np.random.default_rng(seed + 9)
    start = torch.from_numpy(g.uniform(0, 2, (HEIGHT, WIDTH, 3))
                             .astype(np.float32)).to(dev)
    err = 0.0
    cases = [(RenderConfig(width=WIDTH, height=HEIGHT), 2**32 - 2, [(0, 0)]),
             (RenderConfig(width=WIDTH, height=HEIGHT, tile_size=7,
                           frames_per_step=2), 2**24 + 1,
              [(0, 0), (7, 7), (3, 7)])]
    for cfg, frame, tiles in cases:
        got, ref = start.clone(), start.clone()
        tw, th, F = cfg.tile_w, cfg.tile_h, cfg.frames_per_step
        for tx, ty in tiles:
            cols = tuple(torch.from_numpy(g.uniform(0, 3, F * tw * th)
                                          .astype(np.float32)).to(dev)
                         for _ in range(3))
            bk, bp = step_block.new(dev), step_block.new(dev)
            for b, acc in ((bk, got), (bp, ref)):
                step_block.write_plain(b, step_words(cfg, frame, tx, ty,
                                                     camera, 1.0, 0.0, True,
                                                     acc))
            fold.fold_band(got, cols, bk, tw, th, F, F)
            fold.fold_plain(ref, cols, bp, tw, th, F, F)
        err = max(err, _assert_equal(f"G6 tile_size={cfg.tile_size}", got,
                                     ref, bits=True))
    # the "packet" traversal's 8x16 block order: the whole 1080p frame at
    # frames_per_step 1 and 2
    err_blocks = 0.0
    for F in (1, 2):
        cfg = RenderConfig(width=WIDTH, height=HEIGHT, frames_per_step=F,
                           traversal="packet")
        got, ref = start.clone(), start.clone()
        cols = tuple(torch.from_numpy(g.uniform(0, 3, F * N_RAYS)
                                      .astype(np.float32)).to(dev)
                     for _ in range(3))
        bk, bp = step_block.new(dev), step_block.new(dev)
        for b, acc in ((bk, got), (bp, ref)):
            step_block.write_plain(b, step_words(cfg, 2**32 - 2, 0, 0, camera,
                                                 1.0, 0.0, True, acc))
        fold.fold_band(got, cols, bk, WIDTH, HEIGHT, F, F, blocks=True)
        fold.fold_plain(ref, cols, bp, WIDTH, HEIGHT, F, F, blocks=True)
        err_blocks = max(err_blocks, _assert_equal(
            f"G6 blocks F={F}", got, ref, bits=True))
    cfg = cases[0][0]
    cols = tuple(torch.rand(N_RAYS, device=dev) for _ in range(3))
    acc_k, acc_p = start.clone(), start.clone()
    blocks = []
    for acc in (acc_k, acc_p):
        blocks.append(step_block.new(dev))
        step_block.write_plain(blocks[-1], step_words(cfg, 5, 0, 0, camera,
                                                      1.0, 0.0, True, acc))
    ms, plain_ms = time_pair(
        lambda: fold.fold_band(acc_k, cols, blocks[0], WIDTH, HEIGHT, 1, 1),
        lambda: fold.fold_plain(acc_p, cols, blocks[1], WIDTH, HEIGHT, 1, 1),
        20, 3)
    ms_blocks = min(cuda_ms(lambda: fold.fold_band(
        acc_k, cols, blocks[0], WIDTH, HEIGHT, 1, 1, blocks=True), 20)
        for _ in range(2))
    extra = dict(blocks_max_abs_err=err_blocks, blocks_ms=ms_blocks)
    return _glue_row("band_fold", max(err, err_blocks), ms, plain_ms,
                     N_RAYS * G6_BYTES_PER_PIXEL, N_RAYS * G6_OPS_PER_PIXEL,
                     set="1080p band, 1 frame", **extra), extra


def demo_box(device):
    """The reference's default scene without its two meshes: 7 boxes, 84
    triangles (88 padded), which "auto" renders by brute force."""
    from opengl_raytracer_torch import Scene

    box = Scene(standin_objects(83, 166)[2:])
    if box.total_triangles != 84:
        raise RuntimeError(f"the demo box has {box.total_triangles} "
                           f"triangles, expected 84")
    return box, box.send(device)


def _g7_set(name, scene, camera, seed):
    """G7 against its plain version bit for bit on phase 3's kind of rays
    (half primary, half random in the scene, a tenth dead) over
    ``scene``; its times, counts and bound."""
    from opengl_raytracer_torch.ops import traversal
    from opengl_raytracer_torch.ops.intersect import BIG
    from opengl_raytracer_torch.renderer import effective_max_leaf

    leaf = effective_max_leaf(scene)
    o3, d3, t0 = k1_rays(scene, camera, seed, scene.device)
    active = t0 > -BIG
    got = traversal.raycast_bvh(scene, o3, d3, active, leaf)
    ref, work = traversal._walk_plain(scene, o3, d3, active, leaf,
                                      counts=True)
    err = _assert_equal(f"G7 {name}", tuple(got[:4]), tuple(ref[:4]))
    hit = int((got.t < BIG).sum())
    if hit < N_RAYS // 4:
        raise RuntimeError(f"G7 {name}: only {hit} of {N_RAYS} rays hit")
    ms, plain_ms = time_pair(
        lambda: traversal.raycast_bvh(scene, o3, d3, active, leaf),
        lambda: traversal._walk_plain(scene, o3, d3, active, leaf), 10, 1)
    live = int(active.sum())
    all_visits = int(work[0].long().sum())
    visits, tests, cands = (int(w[active].long().sum()) for w in work)
    records = (scene.node_records, scene.tri_records)
    n_bytes = N_RAYS * RAY_IN_OUT_BYTES + sum(
        x.numel() * x.element_size() for x in records)
    ops = (visits * G7_OPS_PER_VISIT + tests * G7_OPS_PER_TEST
           + cands * G7_OPS_PER_CANDIDATE)
    old_bound = bound_ms(n_bytes, all_visits * G7_OPS_PER_VISIT
                         + tests * G7_OPS_PER_TEST_FULL)[0]
    return dict(set=name, err=err, ms=ms, plain_ms=plain_ms, n_bytes=n_bytes,
                ops=ops, hit=hit, visits_per_live_ray=visits / live,
                tests_per_live_ray=tests / live,
                candidates_per_live_ray=cands / live,
                node_record_bytes=records[0].shape[1] * 4,
                bound_ms_full_tests=old_bound)


def _g7_rows(camera, seed, data):
    """G7, the "bvh" walk, on phase 3's kind of rays over the 84-triangle
    demo box (its row) and over standin-31k ``data`` (more keys of the
    row); its bound from the plain version's counts (a live ray's node
    visits, triangle tests and candidates)."""
    _, box = demo_box(DEVICE)
    rows = [_g7_set("random rays, 84-triangle box", box, camera, seed),
            _g7_set("random rays, standin-31k", data, camera, seed)]
    for r in rows:
        b, by = bound_ms(r["n_bytes"], r["ops"])
        say("glue", kernel="bvh_walk", rays=N_RAYS,
            **{k: v for k, v in r.items() if k not in ("err", "n_bytes",
                                                       "ops")},
            mbytes=round(r["n_bytes"] / 1e6, 3), gop=r["ops"] / 1e9,
            bound_ms=b, bound_by=by, share_of_bound=b / r["ms"],
            max_abs_err=r["err"], tolerance="exact")
    box_row, big = rows
    extra = {f"standin31k_{k}": big[k] for k in (
        "ms", "plain_ms", "visits_per_live_ray", "tests_per_live_ray",
        "candidates_per_live_ray")}
    extra["standin31k_bound_ms"] = bound_ms(big["n_bytes"], big["ops"])[0]
    extra.update({k: box_row[k] for k in (
        "visits_per_live_ray", "tests_per_live_ray",
        "candidates_per_live_ray", "bound_ms_full_tests")})
    row = (max(r["err"] for r in rows), box_row["ms"], box_row["plain_ms"],
           bound_ms(box_row["n_bytes"], box_row["ops"]))
    return row, dict(set=box_row["set"], **extra)


def matmul_sweep(scene, o3, d3, active=None, tri_chunk: int = 2048):
    """The port's brute force before its sweep kernel (the JAX package's
    matmul form: ``torch.matmul`` in full float32 over chunks of 2048
    triangles), kept here only as the yardstick G8 replaced; the port does
    not call it."""
    from opengl_raytracer_torch.ops.intersect import (BIG, EPS, init_nearest,
                                                      unpack_tri_records)

    origin = torch.stack(tuple(o3), dim=1)
    direction = torch.stack(tuple(d3), dim=1)
    R = origin.shape[0]
    near = init_nearest(R, origin.device)
    cols = unpack_tri_records(scene.tri_records)
    T = scene.num_tris
    C = min(tri_chunk, T)
    cross_od = torch.linalg.cross(origin, direction)
    t_best, tri, u_best, v_best = near.t, near.tri, near.u, near.v
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for base in range(0, T, C):
            v0, e1, e2, face = (x[base:base + C] for x in cols)
            d0 = (v0 * face).sum(dim=1)
            q1 = torch.linalg.cross(e1, v0)
            q2 = torch.linalg.cross(e2, v0)
            det = direction @ face.T
            inv_det = 1.0 / det
            t = (d0[None, :] - origin @ face.T) * inv_det
            u = -(cross_od @ e2.T - direction @ q2.T) * inv_det
            v = (cross_od @ e1.T - direction @ q1.T) * inv_det
            valid = ((det.abs() >= EPS) & (t > EPS) & (u >= 0.0)
                     & (v >= 0.0) & ((u + v) <= 1.0))
            ts = torch.where(valid, t, BIG)
            arg = torch.argmin(ts, dim=1, keepdim=True)
            bt = ts.gather(1, arg)[:, 0]
            better = bt < t_best
            t_best = torch.where(better, bt, t_best)
            tri = torch.where(better, (arg[:, 0] + base).to(torch.int32), tri)
            u_best = torch.where(better, u.gather(1, arg)[:, 0], u_best)
            v_best = torch.where(better, v.gather(1, arg)[:, 0], v_best)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if active is not None:
        t_best = torch.where(active, t_best, BIG)
        any_active = active.any()
        tri, u_best, v_best = (torch.where(any_active, x, y) for x, y in (
            (tri, near.tri), (u_best, near.u), (v_best, near.v)))
    return t_best, tri, u_best, v_best


def _g8_rows(camera, seed):
    """G8, the brute-force sweep, against its plain version bit for bit on
    phase 3's kind of rays over the 84-triangle demo box; its bound from
    the plain version's counts (live pairs and candidates), and the time
    of the matmul sweep it replaced on the same rays (the port's brute
    force before G8)."""
    from opengl_raytracer_torch.ops import intersect
    from opengl_raytracer_torch.ops.intersect import BIG

    _, box = demo_box(DEVICE)
    o3, d3, t0 = k1_rays(box, camera, seed, box.device)
    active = t0 > -BIG
    got = intersect.raycast_brute(box, o3, d3, active)
    ref, work = intersect._sweep_plain(box, o3, d3, active, counts=True)
    err = _assert_equal("G8", tuple(got[:4]), tuple(ref[:4]))
    hit = int((got.t < BIG).sum())
    if hit < N_RAYS // 4:
        raise RuntimeError(f"G8: only {hit} of {N_RAYS} rays hit")
    old = matmul_sweep(box, o3, d3, active)
    hits_agree = float(((old[0] < BIG) == (got.t < BIG)).float().mean())
    del ref, old
    ms, plain_ms = time_pair(
        lambda: intersect.raycast_brute(box, o3, d3, active),
        lambda: intersect._sweep_plain(box, o3, d3, active), 10, 2)
    matmul_ms = min(cuda_ms(lambda: matmul_sweep(box, o3, d3, active), 2)
                    for _ in range(2))
    live = int(active.sum())
    pairs, cands = (int(w.sum()) for w in work)
    ops = (live * G8_OPS_PER_RAY + pairs * G8_OPS_PER_PAIR
           + cands * G8_OPS_PER_CANDIDATE)
    n_bytes = (N_RAYS * RAY_IN_OUT_BYTES
               + box.tri_records.numel() * 4)
    extra = dict(set="random rays, 84-triangle box", triangles=box.num_tris,
                 pairs_per_live_ray=pairs / live,
                 candidates_per_live_ray=cands / live,
                 matmul_sweep_ms=matmul_ms,
                 matmul_sweep_hit_set_agreement=hits_agree)
    row = _glue_row("brute_sweep", err, ms, plain_ms, n_bytes, ops, hit=hit,
                    gop=ops / 1e9, **extra)
    return row, extra


def _packet_union(scene, o3, d3, active, leaf):
    """What the live rays' own per-ray walks do, and what a packet's live
    rays need between them.  The per-ray walk is stepped here as
    ``traversal._walk_plain`` steps it, recording the node each live ray
    visits at each step and whether it opens a leaf there, and is held to
    ``_walk_plain``: the same nearest t and node visits for every live
    ray.  Returns, summed over the live rays, ``_walk_plain``'s counts of
    their own node visits, triangle tests and candidates (the work G7's
    row prices), and, summed over the 128-ray packets, the nodes that at
    least one of a packet's live rays visits and the leaf slots of the
    leaves at least one of them opens."""
    from opengl_raytracer_torch.ops import traversal
    from opengl_raytracer_torch.ops.intersect import (BIG, mt_single,
                                                      slab_test,
                                                      unpack_tri_records)

    ref, work = traversal._walk_plain(scene, o3, d3, active, leaf,
                                      counts=True)
    node_min, node_max, node_miss, node_first, node_count = (
        traversal.unpack_node_records(scene.node_records))
    tris = unpack_tri_records(scene.tri_records)
    origin = torch.stack(tuple(o3), dim=1)
    direction = torch.stack(tuple(d3), dim=1)
    inv = 1.0 / direction
    R = origin.shape[0]
    N = node_miss.shape[0]
    t = torch.full((R,), BIG, dtype=torch.float32, device=origin.device)
    node = torch.where(active, 0, N).long()  # dead rays walk nothing
    visits = torch.zeros(R, dtype=torch.int32, device=origin.device)
    keys, leaves = [], []
    while True:
        rays = torch.nonzero(node < N).squeeze(1)
        if rays.numel() == 0:
            break
        nidx = node[rays]
        visits[rays] += 1
        t_near = slab_test(origin[rays], inv[rays], node_min[nidx],
                           node_max[nidx])
        box_hit = (t_near >= 0.0) & (t_near <= t[rays])
        is_leaf = node_count[nidx] > 0
        key = rays // traversal.PACKET * N + nidx
        keys.append(key)
        opens = box_hit & is_leaf
        leaves.append(key[opens])
        lr, ln = rays[opens], nidx[opens]
        o_l, d_l = origin[lr].unbind(1), direction[lr].unbind(1)
        for k in range(leaf if lr.numel() else 0):
            ok = k < node_count[ln]
            idx = torch.where(ok, node_first[ln] + k, 0).long()
            valid, tk, _, _ = mt_single(o_l, d_l, *(
                tab[idx].unbind(1) for tab in tris))
            bt = t[lr]
            t[lr] = torch.where(ok & valid & (tk < bt), tk, bt)
        node[rays] = torch.where(box_hit & ~is_leaf, nidx + 1,
                                 node_miss[nidx].long())
    if not (torch.equal(t[active], ref.t[active])
            and torch.equal(visits[active], work[0][active])):
        raise RuntimeError("the stepped per-ray walk is not _walk_plain's")
    union_visits = int(torch.unique(torch.cat(keys)).numel())
    opened = torch.unique(torch.cat(leaves)) % N
    union_slots = int(node_count[opened].clamp_max(leaf).long().sum())
    own = tuple(int(w[active].long().sum()) for w in work)
    return (*own, union_visits, union_slots)


def _g9_set(name, scene, o3, d3, t0, plain: bool):
    """G9 against its plain version bit for bit on the rays (o3, d3) with
    entry t0 (-BIG: dead) over ``scene``; its ms (and with ``plain`` the
    plain version's), the plain version's counts (a packet's node visits
    and slot tests, candidates), the union of what each packet's live rays
    do alone (:func:`_packet_union`), the waste (the lanes' visits and
    tests over the live rays' own), the operations of the bound (``ops``:
    the live rays' own visits, tests and candidates, priced as G7's row
    prices them, the work the answer needs) and the lanes' (``lane_ops``:
    each live ray at each of its packet's visits and slot tests, with
    the packet walk's candidates)."""
    from opengl_raytracer_torch.ops import traversal
    from opengl_raytracer_torch.ops.intersect import BIG
    from opengl_raytracer_torch.renderer import effective_max_leaf

    leaf = effective_max_leaf(scene)
    active = t0 > -BIG
    R = o3[0].shape[0]

    def kernel():
        return traversal.raycast_packet(scene, o3, d3, active, leaf)

    got = kernel()
    ref, work = traversal._packet_plain(scene, o3, d3, active, leaf,
                                        counts=True)
    err = _assert_equal(f"G9 {name}", tuple(got[:4]), tuple(ref[:4]))
    hit = int((got.t < BIG).sum())
    del ref
    ms = min(cuda_ms(kernel, 5) for _ in range(2))
    plain_ms = cuda_ms(lambda: traversal._packet_plain(
        scene, o3, d3, active, leaf), 1) if plain else None
    live_p = active.view(-1, traversal.PACKET).long().sum(1)
    live, packets = int(live_p.sum()), int((live_p > 0).sum())
    lane_visits = int((work.visits.long() * live_p).sum())
    lane_slots = int((work.slots.long() * live_p).sum())
    cands = int(work.candidates.long().sum())
    own_visits, own_tests, own_cands, union_visits, union_slots = (
        _packet_union(scene, o3, d3, active, leaf))
    records = (scene.node_records, scene.tri_records)
    n_bytes = R * RAY_IN_OUT_BYTES + sum(
        x.numel() * x.element_size() for x in records)
    ops = (own_visits * G7_OPS_PER_VISIT + own_tests * G7_OPS_PER_TEST
           + own_cands * G7_OPS_PER_CANDIDATE)
    lane_ops = (lane_visits * G7_OPS_PER_VISIT + lane_slots * G7_OPS_PER_TEST
                + cands * G7_OPS_PER_CANDIDATE)
    return dict(
        set=name, err=err, ms=ms, plain_ms=plain_ms, n_bytes=n_bytes,
        ops=ops, lane_ops=lane_ops, hit=hit, live_rays=live,
        live_packets=packets,
        visits_per_packet=int(work.visits.long().sum()) / packets,
        union_visits_per_packet=union_visits / packets,
        slots_per_packet=int(work.slots.long().sum()) / packets,
        union_slots_per_packet=union_slots / packets,
        own_visits_per_live_ray=own_visits / live,
        own_tests_per_live_ray=own_tests / live,
        own_candidates_per_live_ray=own_cands / live,
        waste_visits=lane_visits / own_visits,
        waste_tests=lane_slots / own_tests,
        candidates_per_live_ray=cands / live)


def _g9_rows(camera, seed, data, segments):
    """G9, the packet walk, on phase 3's kind of rays over the 84-triangle
    demo box and over standin-31k ``data`` (its row: ms, plain ms, bound)
    and on the five bounce segments of one 1080p "packet" frame of
    standin-31k (``segments``, after the reorder; more keys of the row);
    the bound from the work the answer needs, the live rays' own per-ray
    walks priced as G7's row prices them (the same function on the same
    rays), and beside it ``lane_bound_ms``, each live ray priced at each
    of its packet's node visits and slot tests (what the packet walk
    does)."""
    _, box = demo_box(DEVICE)
    sets = [("random rays, 84-triangle box", box,
             *k1_rays(box, camera, seed, box.device), True),
            ("random rays, standin-31k", data,
             *k1_rays(data, camera, seed, data.device), True)]
    sets += [(f"standin-31k packet frame segment {i}", data, *seg, False)
             for i, seg in enumerate(segments)]
    rows = []
    for name, *args in sets:
        r = _g9_set(name, *args)
        b, by = bound_ms(r["n_bytes"], r["ops"])
        r["bound"] = (b, by)
        r["lane_bound_ms"] = bound_ms(r["n_bytes"], r["lane_ops"])[0]
        say("glue", kernel="packet_walk", rays=N_RAYS,
            **{k: v for k, v in r.items() if k not in (
                "err", "n_bytes", "ops", "lane_ops", "bound")},
            mbytes=round(r["n_bytes"] / 1e6, 3), gop=r["ops"] / 1e9,
            lane_gop=r["lane_ops"] / 1e9, bound_ms=b, bound_by=by,
            share_of_bound=b / r["ms"],
            lane_share_of_bound=r["lane_bound_ms"] / r["ms"],
            max_abs_err=r["err"], tolerance="exact")
        rows.append(r)
    box_row, big, segs = rows[0], rows[1], rows[2:]
    keys = ("visits_per_packet", "union_visits_per_packet",
            "slots_per_packet", "union_slots_per_packet",
            "own_visits_per_live_ray", "waste_visits", "waste_tests")
    extra = dict(set=big["set"], lane_bound_ms=big["lane_bound_ms"],
                 **{k: big[k] for k in keys})
    extra.update({f"box_{k}": box_row[k] for k in ("ms", "plain_ms",
                                                   "lane_bound_ms", *keys)})
    extra["box_bound_ms"] = box_row["bound"][0]
    extra["frame_segments_ms"] = [r["ms"] for r in segs]
    extra["frame_ms"] = sum(r["ms"] for r in segs)
    extra["frame_bound_ms"] = sum(r["bound"][0] for r in segs)
    extra["frame_lane_bound_ms"] = sum(r["lane_bound_ms"] for r in segs)
    for k in keys:
        extra[f"frame_segments_{k}"] = [r[k] for r in segs]
    row = (max(r["err"] for r in rows), big["ms"], big["plain_ms"],
           big["bound"])
    return row, extra


def _block_rows(dev, camera):
    """The step block's write against its plain version (a copy of the
    same words), bit for bit; its time beside the plain version's and,
    timed the same way in turns, one ``copy_`` from a pinned host tensor
    (the library call; a pageable one beside it)."""
    from opengl_raytracer_torch.ops import step_block

    words = step_block.pack(2**32 + 9, (1, 2, 3, 4, 5), camera, 0.7, 0.05,
                            False, accum=0x7000_0000_1000)
    got, ref = step_block.new(dev), step_block.new(dev)
    step_block.write(got, words)
    step_block.write_plain(ref, words)
    err = _assert_equal("step block", got, ref)
    host = torch.from_numpy(words)
    pinned = host.pin_memory()
    ms, plain_ms = time_pair(lambda: step_block.write(got, words),
                             lambda: step_block.write_plain(ref, words),
                             50, 50)
    ms_turn, lib = time_pair(lambda: step_block.write(got, words),
                             lambda: ref.copy_(pinned, non_blocking=True),
                             50, 50)
    torch.cuda.synchronize()
    _assert_equal("pinned copy", ref, got)
    pageable = min(cuda_ms(lambda: ref.copy_(host), 50) for _ in range(2))
    row = _glue_row("step_block", err, ms, plain_ms, 2 * step_block.WORDS * 4,
                    0, library_ms=lib, ms_beside_library=ms_turn,
                    pageable_copy_ms=pageable)
    return row, dict(library_ms=lib, ms_beside_library=ms_turn,
                     pageable_copy_ms=pageable)


def frame_states(data, camera, frames_per_step: int = 1, frame: int = 0):
    """The pre-reorder states of one 1920x1080 "auto" step (K1) of
    ``frames_per_step`` frames from frame number ``frame``, four a chunk:
    each (state, recon, draws), the state as the integrator hands it to
    ``permute.reorder`` (sorted keys, permutation, the four column groups,
    seed, original index) with its seed-reconstruction descriptor and
    draws; and each chunk's restore input (incoming light, seed, original
    index), captured by wrapping the two entry points during the step."""
    from opengl_raytracer_torch import RenderConfig, Renderer
    from opengl_raytracer_torch import renderer as rmod
    from opengl_raytracer_torch.ops import permute

    def clone(x):
        if isinstance(x, tuple):
            return tuple(clone(y) for y in x)
        return x.clone() if isinstance(x, torch.Tensor) else x

    states, restores = [], []
    reorder, restore = permute.reorder, permute.restore

    def rec_reorder(*args):
        if args[8]:
            raise RuntimeError("the 1 spp frame reorders with return_seed")
        if args[9] is None:
            raise RuntimeError("the 1 spp frame reorders without seed "
                               "reconstruction")
        # the block as this reorder reads it: after the step it holds the
        # next step's words, written ahead
        recon = args[9]._replace(block=args[9].block.clone())
        states.append((clone(args[:8]), recon, args[10]))
        return reorder(*args)

    def rec_restore(*args):
        restores.append(clone(args))
        return restore(*args)

    r = Renderer(data, RenderConfig(width=WIDTH, height=HEIGHT,
                                    bounces=BOUNCES,
                                    frames_per_step=frames_per_step),
                 device=DEVICE)
    state = r.init_state()
    state.frame_count = frame
    permute.reorder, permute.restore = rec_reorder, rec_restore
    try:
        eager_render(r, camera, frames_per_step, state)
    finally:
        permute.reorder, permute.restore = reorder, restore
    torch.cuda.synchronize()
    chunks = -(-N_RAYS * frames_per_step // rmod._DEFAULT_CHUNK)
    if (r.traversal != "pallas2"
            or len(states) != (r.config.n_bounces - 1) * chunks
            or len(restores) != chunks
            or any(x[1] is not None for x in restores)):
        raise RuntimeError(f"captured {len(states)} reorders and "
                           f"{len(restores)} restores of {r.traversal}")
    return states, restores


def _g3_recon_check(data, camera, main_frame) -> float:
    """G3 with seed reconstruction, on a frame's own states: the main
    path's 1080p frame (``main_frame``, from :func:`frame_states`) and one
    step of frames_per_step 2 from frame number 2^32 + 3 (two chunks, the
    second padded past the step's 4,147,200 rays; frame numbers past 2^32).
    At each state (bounces 1-4 of each chunk) the reorder with
    reconstruction equals its plain version and the carried-seed reorder
    byte for byte: every live ray's rebuilt seed is its carried one,
    padding rays included (all of them are pixel (0, 0), so they live or
    die together; the count of live ones checked is printed).  Returns the
    max |d| (0.0)."""
    from opengl_raytracer_torch.ops import permute

    fps2, _ = frame_states(data, camera, frames_per_step=2, frame=2**32 + 3)
    err, live_padding = 0.0, 0
    for tag, states in (("frame", main_frame), ("fps2", fps2)):
        for k, (st, recon, draws) in enumerate(states):
            name = f"G3 recon {tag} chunk {recon.base} draws {draws}"
            got = permute.reorder(*st, False, recon, draws)
            err = max(err, _assert_equal(
                name, got, permute.reorder_plain(*st, False, recon, draws),
                bits=True))
            err = max(err, _assert_equal(f"{name} vs carried", got,
                                         permute.reorder(*st, False),
                                         bits=True))
            padded = int((got[4] & (recon.base + got[6] >= recon.n_rays))
                         .sum())
            live_padding += padded
            say("glue", kernel="reorder", recon_set=tag, chunk=recon.base,
                n_rays=recon.n_rays, draws=draws,
                first_frame=2**32 + 3 if tag == "fps2" else 0,
                live=int(got[4].sum()), live_padding=padded,
                tolerance="byte for byte (kernel, plain, carried seed)")
    say("glue", kernel="reorder", recon_states=len(main_frame) + len(fps2),
        live_padding_rays_checked=live_padding)
    return err


def _g3_index_widths(frame, turns: int = 2, iters: int = 20) -> dict:
    """The reorder with seed reconstruction as the port builds it (64-bit
    index math in its index pass) against ``build_recon32``'s build (32-bit,
    exact here: a 1080p step's indices are below 2^32), on the 1080p
    frame's four pre-reorder states (``frame``, from :func:`frame_states`):
    the two equal byte for byte; then ``turns`` rounds of i64, u32, u32,
    i64, each run the mean ms of ``iters`` calls (both launches) summed
    over the four states.  The gathers are the same code, so the
    difference is the index pass's.  Returns the runs, their means and
    whether the 32-bit build wins by more than the larger spread."""
    import functools

    from opengl_raytracer_torch.ops import _kernels, permute

    def on_u32(fn):
        def call():
            saved, _kernels._lib = _kernels._lib, _recon32["lib"]
            try:
                return fn()
            finally:
                _kernels._lib = saved
        return call

    calls = {"i64": [], "u32": []}
    for st, recon, draws in frame:
        fn = functools.partial(permute.reorder, *st, False, recon, draws)
        calls["i64"].append(fn)
        calls["u32"].append(on_u32(fn))
        _assert_equal(f"G3 recon u32 build draws {draws}", calls["u32"][-1](),
                      fn(), bits=True)
    runs = {"i64": [], "u32": []}
    for _ in range(turns):
        for width in ("i64", "u32", "u32", "i64"):
            runs[width].append(sum(cuda_ms(f, iters) for f in calls[width]))
    mean = {w: sum(r) / len(r) for w, r in runs.items()}
    spread = max(max(r) - min(r) for r in runs.values())
    out = dict(recon_i64_ms_frame_runs=runs["i64"],
               recon_u32_ms_frame_runs=runs["u32"],
               recon_i64_ms_frame=mean["i64"], recon_u32_ms_frame=mean["u32"],
               recon_width_spread_ms=spread,
               u32_wins_beyond_spread=mean["i64"] - mean["u32"] > spread)
    say("glue", kernel="reorder", check="index width", states=len(frame),
        tolerance="byte for byte (u32 build vs i64)", **out)
    return out


def _g3_check(name, st) -> tuple[float, float]:
    """Reorder and restore against their plain versions byte for byte on
    state ``st``, with return_seed on and off; their max |d| (0.0)."""
    from opengl_raytracer_torch.ops import permute

    errs = [0.0, 0.0]
    for rs in (True, False):
        ref = permute.reorder_plain(*st, rs)
        fwd = permute.reorder(*st, rs)
        errs[0] = max(errs[0], _assert_equal(
            f"G3 reorder {name} return_seed={rs}", fwd, ref, bits=True))
        seed = ref[5] if rs else None
        errs[1] = max(errs[1], _assert_equal(
            f"G3 restore {name} return_seed={rs}",
            permute.restore(fwd[3], seed, fwd[6]),
            permute.restore_plain(ref[3], seed, ref[6]), bits=True))
    return errs[0], errs[1]


def _g3_live_light(name, st) -> None:
    """Every live ray of a captured state carries +0.0 light, in bits."""
    from opengl_raytracer_torch.ops.morton import DEAD_KEY32

    keys_s, perm, incoming = st[0], st[1], st[5]
    live = torch.empty_like(keys_s, dtype=torch.bool)
    live[perm] = keys_s != DEAD_KEY32
    for a in range(3):
        bad = int((incoming[a].view(torch.int32)[live] != 0).sum())
        if bad:
            raise RuntimeError(f"G3 {name}: {bad} live rays carry light")


def _g3_times(name, st, recon=None) -> dict:
    """The reorder (return_seed off, as the 1 spp frame runs it; with
    ``recon`` = (descriptor, draws), with seed reconstruction, as the main
    path runs it) and the restore of its output on state ``st``: ms of the
    kernel, in turns with the carried-seed reorder's, of its plain version
    and of the one PyTorch call (``torch.index_select`` of a pre-stacked
    (12, R) buffer by the int32 permutation; ``index_copy_`` of a (3, R)
    light buffer by an int64 copy of the index); bytes, bound and scattered
    sectors at the state's live share.  The reorder's ms covers both its
    launches."""
    from opengl_raytracer_torch.ops import permute
    from opengl_raytracer_torch.ops.morton import DEAD_KEY32

    keys_s, perm = st[:2]
    alive = keys_s != DEAD_KEY32
    stacked = torch.stack([c for grp in st[2:6] for c in grp])
    rc = () if recon is None else recon
    ms, carried_ms = time_pair(lambda: permute.reorder(*st, False, *rc),
                               lambda: permute.reorder(*st, False), 20, 20)
    plain_ms = min(cuda_ms(lambda: permute.reorder_plain(*st, False, *rc), 3)
                   for _ in range(2))
    lib = min(cuda_ms(lambda: torch.index_select(stacked, 1, perm), 20)
              for _ in range(2))
    n_bytes, sectors = g3_reorder_work(alive, False, recon is not None)
    bound, _ = bound_ms(n_bytes, 0)
    old_bound, _ = bound_ms(N_RAYS * G3_UNFOLDED_REORDER_BYTES_PER_RAY, 0)
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, n_bytes=n_bytes,
               live=float(alive.float().mean()), sectors=sectors,
               carried_ms=carried_ms)
    say("glue", kernel="reorder", set=name, rays=N_RAYS,
        seed_recon=recon is not None, carried_seed_ms=carried_ms,
        live_share=row["live"], ms=ms, plain_ms=plain_ms, library_ms=lib,
        mbytes=round(n_bytes / 1e6, 3), bound_ms=bound,
        share_of_bound=bound / ms, unfolded_mbytes=round(
            N_RAYS * G3_UNFOLDED_REORDER_BYTES_PER_RAY / 1e6, 3),
        unfolded_bound_ms=old_bound, scattered_msectors=round(sectors / 1e6, 3),
        sector_gbps=sectors * 32 / ms / 1e6,
        slower_than_library=ms > lib)
    fwd = permute.reorder(*st, False)
    r = _g3_restore_times(fwd[3], None, fwd[6], name)
    row.update(restore_ms=r[0], restore_library_ms=r[2])
    return row


def _g3_restore_times(incoming, seed, orig, name="frame"):
    """The restore on (incoming, seed, orig): (ms, plain ms, library ms,
    bytes, more keys) with its bound and scattered sectors."""
    from opengl_raytracer_torch.ops import permute

    light = torch.stack(incoming)
    dst = torch.empty_like(light)
    orig64 = orig.long()
    ms, plain_ms = time_pair(lambda: permute.restore(incoming, seed, orig),
                             lambda: permute.restore_plain(incoming, seed,
                                                           orig), 20, 3)
    lib = min(cuda_ms(lambda: dst.index_copy_(1, orig64, light), 20)
              for _ in range(2))
    n_bytes, sectors = g3_restore_work(orig.numel(), seed is not None)
    bound, _ = bound_ms(n_bytes, 0)
    extra = dict(scattered_msectors=round(sectors / 1e6, 3),
                 sector_gbps=sectors * 32 / ms / 1e6,
                 unfolded_bound_ms=bound_ms(
                     orig.numel() * G3_UNFOLDED_RESTORE_BYTES_PER_RAY, 0)[0])
    say("glue", kernel="restore", set=name, rays=orig.numel(), ms=ms,
        plain_ms=plain_ms, library_ms=lib, mbytes=round(n_bytes / 1e6, 3),
        bound_ms=bound, share_of_bound=bound / ms,
        slower_than_library=ms > lib, **extra)
    return ms, plain_ms, lib, n_bytes, extra


def _g3_mean(rows):
    """The reorder's row over the frame's segments: mean ms, plain ms and
    library ms a launch, mean bytes, and the live shares and each
    segment's times."""
    n = len(rows)

    def mean(k):
        return sum(r[k] for r in rows) / n

    extra = dict(live_shares=[r["live"] for r in rows],
                 ms_segments=[r["ms"] for r in rows],
                 carried_seed_ms=mean("carried_ms"),
                 carried_seed_ms_segments=[r["carried_ms"] for r in rows],
                 library_ms_segments=[r["library_ms"] for r in rows],
                 scattered_msectors=round(mean("sectors") / 1e6, 3),
                 sector_gbps=mean("sectors") * 32 / mean("ms") / 1e6,
                 unfolded_bound_ms=bound_ms(
                     N_RAYS * G3_UNFOLDED_REORDER_BYTES_PER_RAY, 0)[0],
                 restore_ms_segments=[r["restore_ms"] for r in rows])
    return (mean("ms"), mean("plain_ms"), mean("library_ms"),
            mean("n_bytes"), extra)


def frame_sort_keys(data, camera) -> list:
    """G2's keys of one 1920x1080 "auto" frame (K1), as the integrator
    hands them to each of its four sorts (before segments 1-4), captured
    by wrapping ``radix_sort.sort_rays`` during the frame."""
    from opengl_raytracer_torch import RenderConfig, Renderer
    from opengl_raytracer_torch.ops import radix_sort

    taken = []
    sort_rays = radix_sort.sort_rays

    def spy(keys):
        taken.append(keys.clone())
        return sort_rays(keys)

    r = Renderer(data, RenderConfig(width=WIDTH, height=HEIGHT,
                                    bounces=BOUNCES), device=DEVICE)
    radix_sort.sort_rays = spy
    try:
        eager_render(r, camera)
    finally:
        radix_sort.sort_rays = sort_rays
    torch.cuda.synchronize()
    if len(taken) != r.config.n_bounces - 1:
        raise RuntimeError(f"captured {len(taken)} sorts of a frame")
    return taken


def radix_phase(data, camera):
    """G10 (``csrc/radix_sort.cu``) on a frame's own keys: each of the
    four sorts of a 1080p frame at 2,073,600 keys and the first 518,400
    keys of each (a quarter frame's count), against ``torch.sort(keys,
    stable=True)`` (its indices as int32; the plain version of G10), bit
    for bit; ms a sort in turns with the library's, warm (the keys and
    buffers left in L2 by the sort before) and after a 128 MB write that
    flushes L2 before each sort (as in a frame, where K1 runs between two
    sorts), and the two bounds: the least bytes (12 a key) and the LSD
    floor (64 a key).  Returns the kernel row at 2,073,600 keys and its
    extras."""
    from opengl_raytracer_torch.ops import radix_sort

    frame = frame_sort_keys(data, camera)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=frame[0].device)
    rows = {}
    err = 0.0
    for n in RADIX_SIZES:
        sets = [k[:n].contiguous() for k in frame]
        want = [torch.sort(k, stable=True) for k in sets]
        want = [(ks, p.int()) for ks, p in want]
        for k, ref in zip(sets, want):
            err = max(err, _assert_equal(f"G10 n={n}",
                                         radix_sort.sort_rays(k), ref))

        def g10():
            for k in sets:
                radix_sort.sort_rays(k)

        def lib():
            for k in sets:
                torch.sort(k, stable=True)

        ms, lib_ms = (t / len(sets) for t in time_pair(g10, lib, 20, 20))

        def cold(sort, reps=5):
            """Mean ms of a sort whose keys, buffers and code were pushed
            out of L2 by the flush just before it."""
            total = 0.0
            for _ in range(reps):
                for k in sets:
                    flush.fill_(1)
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    sort(k)
                    b.record()
                    b.synchronize()
                    total += a.elapsed_time(b)
            return total / (reps * len(sets))

        lib_cold = cold(lambda k: torch.sort(k, stable=True))
        ms_cold = cold(radix_sort.sort_rays)
        lib_cold = min(lib_cold, cold(lambda k: torch.sort(k, stable=True)))
        ms_cold = min(ms_cold, cold(radix_sort.sort_rays))
        least, _ = bound_ms(n * 12, 0)
        floor, _ = bound_ms(n * 64, 0)
        say("radix", n=n, items=radix_sort.design(n), ms=ms,
            library_ms=lib_ms, ms_after_flush=ms_cold,
            library_ms_after_flush=lib_cold, least_bytes_bound_ms=least,
            lsd_floor_ms=floor, share_of_least=least / ms,
            share_of_floor=floor / ms, faster_than_library=ms < lib_ms,
            dead_share=float((frame[-1][:n] == 2**31 - 1).float().mean()))
        rows[n] = (ms, lib_ms, ms_cold, lib_cold)
    del flush
    ms, lib_ms, ms_cold, lib_cold = rows[N_RAYS]
    row = (err, ms, lib_ms, bound_ms(N_RAYS * 12, 0))
    return row, dict(library_ms=lib_ms, ms_after_flush=ms_cold,
                     library_ms_after_flush=lib_cold,
                     quarter_ms=rows[N_RAYS // 4][0],
                     quarter_library_ms=rows[N_RAYS // 4][1])


def _kernels_counts() -> dict:
    from opengl_raytracer_torch.ops import _kernels

    return dict(_kernels.launch_counts)


def k3_bound(w: dict, data) -> tuple:
    """K3's operations for the ray set whose counts ``w`` holds
    (``probes/k3.work``): as the kernel does them and at a full triangle
    test per slot (the earlier yardstick); its bytes over the scene's
    Hopper tables; and the bound the first gives."""
    ops = (w["live"] * K3_OPS_PER_RAY + w["visits"] * K3_OPS_PER_NODE
           + w["slots"] * K3_OPS_PER_SLOT
           + w["candidates"] * K3_OPS_PER_CANDIDATE)
    ops_full = (w["live"] * K3_OPS_PER_RAY + w["visits"] * K3_OPS_PER_NODE
                + w["slots"] * K3_OPS_PER_SLOT_FULL)
    n_bytes = (w["rays"] * TRAVERSAL_BYTES_PER_RAY
               + sum(x.numel() * x.element_size() for x in data.k3))
    return (ops, ops_full, n_bytes, *bound_ms(n_bytes, ops))


def k3_phase(scenes, camera, seed: int):
    """K3 against its plain version on four ray sets: for each scene of
    ``scenes`` ((name, SceneData, frame segments) pairs), phase 3's random
    rays and the frame's five segments.  Returns (max_abs_err, ms,
    plain_ms, (bound_ms, bound_by)) of the first scene's random rays."""
    from opengl_raytracer_torch.ops import pallas_traversal as wide
    from opengl_raytracer_torch.ops.intersect import BIG
    from opengl_raytracer_torch.probes import k3 as k3_probe

    out = None
    for scene_name, data, segments in scenes:
        device = data.device
        stack = wide.stack_size(data.pw_max_stack)
        column = wide.group_column(data.pw_max_stack)
        sets = [("random", *k1_rays(data, camera, seed, device))]
        sets += [(f"frame_b{i}", *seg) for i, seg in enumerate(segments)]
        ov = wide.overflow_tensor(device)
        frame_ms = 0.0
        for name, o3, d3, t0 in sets:
            tables = (*data.k3, o3, d3, t0, stack)
            ov.zero_()
            kernel = wide.traverse_wide(data, o3, d3, t0)
            *plain, dropped, counts = wide._traverse_plain(*tables,
                                                           counts=True)
            overflow = int(ov.item())
            if overflow or int(dropped):
                raise RuntimeError(f"K3 overflow on {scene_name} {name}: "
                                   f"kernel {overflow} group pushes, plain "
                                   f"{int(dropped)} pushes dropped")
            for field, a, b in zip(("t", "slot", "u", "v"), kernel, plain):
                if not torch.equal(a, b):
                    diff = (a.double() - b.double()).abs().max()
                    raise RuntimeError(f"K3 {field} differs from the plain "
                                       f"version on {scene_name} {name}: "
                                       f"max |d| {diff}")
            t_k = kernel[0]
            hit = int(((t_k < BIG) & (t_k > -BIG)).sum())
            if name == "random" and hit < N_RAYS // 4:
                raise RuntimeError(f"K3: only {hit} of {N_RAYS} rays hit")
            w = k3_probe.work(counts, t0)
            ops, ops_full, n_bytes, bound, by = k3_bound(w, data)
            ms = cuda_ms(lambda: wide.traverse_wide(data, o3, d3, t0), 10)
            say("k3", scene=scene_name, set=name, rays=w["rays"],
                live=w["live"], hit=hit, max_abs_err=0.0, tri_ties=0,
                overflow=overflow, groups=column,
                ms=ms, visits_per_ray=round(w["visits_per_ray"], 3),
                leaves_per_ray=round(w["leaves_per_ray"], 3),
                octets_per_ray=round(w["octets_per_ray"], 3),
                slots_per_ray=round(w["slots_per_ray"], 3),
                candidates_per_ray=round(w["candidates_per_ray"], 3),
                lanes_steps=round(w["lanes_steps"], 4),
                lanes_visits=round(w["lanes_visits"], 4),
                lanes_leaves=round(w["lanes_leaves"], 4),
                gops=round(ops / 1e9, 4), gops_full_tests=round(
                    ops_full / 1e9, 4), mbytes=round(n_bytes / 1e6, 3),
                bound_ms=round(bound, 5), bound_by=by,
                share_of_bound=round(bound / ms, 4),
                share_of_full_test_bound=round(
                    bound_ms(n_bytes, ops_full)[0] / ms, 4))
            if name != "random":
                frame_ms += ms
            elif out is None:
                ms, plain_ms = time_pair(
                    lambda: wide.traverse_wide(data, o3, d3, t0),
                    lambda: wide._traverse_plain(*tables), 5, 1)
                out = (0.0, ms, plain_ms, (bound, by))
                say("k3", scene=scene_name, set=name, ms=ms,
                    plain_ms=plain_ms)
        say("k3", scene=scene_name, frame_ms=frame_ms,
            segments=len(segments),
            tolerance="exact (t, slot, u, v bit for bit)")
    return out


def k3prof_phase(scenes):
    """The K3 profile build on the primary rays and the sorted first-bounce
    rays (segments 0 and 1) of each scene: its hits against the kernel's,
    its counts against the plain version's, its stages, the octets and
    triangles tested per leaf entry and the share of them that are the
    entered leaf's own; then the octet fetch against ``unpack_octets`` of
    the same rows of ``data.k3`` (the tiles' octets)."""
    from opengl_raytracer_torch.ops import _kernels
    from opengl_raytracer_torch.ops import pallas_traversal as wide
    from opengl_raytracer_torch.ops.wide2 import unpack_octets
    from opengl_raytracer_torch.probes import k3 as k3_probe

    before = dict(_kernels.launch_counts)
    runs, iters = 0, 3
    for scene_name, data, segments in scenes:
        stack = wide.stack_size(data.pw_max_stack)
        for name, (o3, d3, t0) in (("primary", segments[0]),
                                   ("bounce1_sorted", segments[1])):
            hits, stages, hist = k3_probe.profile(data, o3, d3, t0)
            runs += 1
            kernel = wide.traverse_wide(data, o3, d3, t0)
            if not all(torch.equal(a, b) for a, b in zip(hits, kernel)):
                raise RuntimeError(f"K3 profile build differs from the "
                                   f"kernel on {scene_name} {name}")
            counts = wide._traverse_plain(*data.k3, o3, d3, t0, stack,
                                          counts=True)[5].long()
            share = k3_probe.own_share(data, hist, stages)
            expect = dict(visits=int(counts[0].sum()),
                          leaves=int(counts[1].sum()),
                          candidates=int(counts[2].sum()),
                          octets=int(counts[3].sum()),
                          slots=int(counts[4].sum()))
            got = {k: stages[k] for k in expect}
            if got != expect or share["entries"] != expect["leaves"] \
                    or share["own_share"] != 1.0 \
                    or share["own_slot_share"] != 1.0:
                raise RuntimeError(f"K3 profile counts {got}, leaf entries "
                                   f"{share}, on {scene_name} {name}; plain "
                                   f"{expect}")
            rep = k3_probe.stage_report(stages)
            say("k3prof", scene=scene_name, set=name, **{
                s: f"{rep[s]['share']:.3f}/{rep[s]['per_event']:.1f}"
                   + (f"/{rep[s]['per_unit']:.1f}" if "per_unit" in rep[s]
                      else "")
                for s in k3_probe.STAGES}, events=rep["events"],
                expands_per_leaf=round(expect["visits"]
                                       / max(expect["leaves"], 1), 3),
                own_octet_share=round(share["own_share"], 4),
                own_slot_share=round(share["own_slot_share"], 4),
                octets_per_entry=round(share["octets_per_entry"], 4),
                slots_per_entry=round(share["slots_per_entry"], 4),
                key="share/cycles-per-event[/per-16B-load-or-triangle]")
            if name == "primary":
                say("k3prof", scene=scene_name, set=name,
                    profile_ms=cuda_ms(lambda: k3_probe.profile(
                        data, o3, d3, t0), iters),
                    kernel_ms=cuda_ms(lambda: wide.traverse_wide(
                        data, o3, d3, t0), iters))
                runs += iters + 1
        idx = [0, 1, 7, 8, 9, 100, 101, 555, data.k3[1].shape[0] - 1]
        idx = [q for q in idx if q < data.k3[1].shape[0]]
        got = k3_probe.octet_fetch(data, idx)
        want = torch.from_numpy(unpack_octets(
            data.k3[1][idx].cpu().numpy())).to(got.device)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise RuntimeError(f"K3 octet fetch differs from its rows on "
                               f"{scene_name}")
        say("k3prof", scene=scene_name, octet_fetch=idx, bits="equal",
            fetch_ms=cuda_ms(lambda: k3_probe.octet_fetch(data, idx), iters))
    launched = {k: _kernels.launch_counts[k] - before[k]
                for k in ("k3_profile", "k3_fetch")}
    if launched != {"k3_profile": runs,
                    "k3_fetch": len(scenes) * (iters + 2)}:
        raise RuntimeError(f"K3 probes launched {launched}")


def render_1080p(scene, camera, traversal: str, frames: int = TIMED_FRAMES):
    """1 warm-up and ``frames`` timed 1080p frames of ``traversal``, the
    launch counts set to 0 just before; returns (renderer, image, counts,
    ms/frame).  No probe kernel may launch."""
    from opengl_raytracer_torch import RenderConfig, Renderer

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, bounces=BOUNCES,
                       traversal=traversal)
    reset_counts()
    r = Renderer(scene, cfg, device=DEVICE)
    state = r.render(camera, frames=1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = r.render(camera, frames=frames, state=state)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = launches()
    check_probes(counts)
    img = r.image(state)
    if img.shape != (HEIGHT, WIDTH, 3):
        raise RuntimeError(f"image shape {img.shape}")
    if not np.isfinite(img).all():
        raise RuntimeError("image holds non-finite values")
    if not 0.01 < float(img.mean()) < 10.0:
        raise RuntimeError(f"image mean {img.mean()} is not a lit frame")
    return r, img, counts, sec * 1000.0 / frames


def card_vs_cpu(scene, camera, traversal: str, limit: float = 1e-4,
                size=SMALL):
    """A 96x54 (``size``) frame of ``traversal`` on the card and on the CPU
    (the plain versions), which must agree; returns (the traversal it
    resolved to, the card run's launch counts)."""
    from opengl_raytracer_torch import RenderConfig, Renderer
    from opengl_raytracer_torch.utils.image import rmse

    cfg = RenderConfig(width=size[0], height=size[1], bounces=BOUNCES,
                       traversal=traversal)
    imgs, resolved, counts = [], [], {}
    for device in (DEVICE, "cpu"):
        reset_counts()
        rs = Renderer(scene, cfg, device=device)
        resolved.append(rs.traversal)
        imgs.append(rs.image(rs.render(camera, frames=1)))
        counts = counts or launches()
        check_probes(counts)
    err = rmse(imgs[0], imgs[1])
    if not (np.isfinite(imgs[0]).all() and float(imgs[0].mean()) > 0.01
            and err < limit):
        raise RuntimeError(f"{traversal} {size[0]}x{size[1]} frame: card vs "
                           f"CPU rmse {err} (limit {limit}), mean "
                           f"{imgs[0].mean()}")
    say("reference", traversal=traversal, resolved=resolved[0],
        width=size[0], height=size[1], rmse_card_vs_cpu=err, limit=limit,
        max_abs=float(np.abs(imgs[0] - imgs[1]).max()))
    return resolved[0], counts


def main_path_phase(scene, camera, out_dir):
    """The port's Renderer at 1080p under "auto" ("pallas2": K1 + K2);
    returns (launch counts, image, ms/frame)."""
    from opengl_raytracer_torch.ops import _kernels

    torch.cuda.reset_peak_memory_stats()  # this phase's and phase 6's peak
    r, img, counts, ms = render_1080p(scene, camera, "auto")
    if r.traversal != "pallas2":
        raise RuntimeError(f"auto resolved to {r.traversal}, not pallas2")
    parts = len(r.scene.k1_parts)
    frames = 1 + TIMED_FRAMES
    check_count(counts, "subblock_traversal", r.config.n_bounces * frames)
    check_count(counts, "shade", r.config.n_bounces * frames)
    check_count(counts, "wide_traversal", 0)
    check_glue(counts, r.traversal, r.config.n_bounces, frames, parts)
    say("main", width=WIDTH, height=HEIGHT, bounces=BOUNCES, parts=parts,
        traversal=r.traversal, ms_per_frame=ms, fps=1000.0 / ms,
        frames=frames, k1_launches=counts["subblock_traversal"],
        k2_launches=counts["shade"],
        glue_launches={k: counts[k] for k in GLUE},
        probe_launches=sum(counts[k] for k in _kernels.PROBE_COUNTERS),
        finite=True, mean=float(img.mean()),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        small = img.reshape(HEIGHT // 4, 4, WIDTH // 4, 4, 3).mean((1, 3))
        np.save(os.path.join(out_dir, "smoke_1080p.npy"),
                small.astype(np.float32))
    card_vs_cpu(scene, camera, "auto")
    return counts, img, ms


DISPLAY_FRAMES = 60  # frames a timed turn of the display phase
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 (data sheet)


def display_least_bytes(width: int, height: int) -> int:
    """Bytes one 8-bit conversion of a width x height frame must move: 3
    float32 channels read and 3 uint8 channels written a pixel."""
    return width * height * 3 * (4 + 1)


def _display_turn(frame, n: int) -> tuple[float, float]:
    """(host ms, CUDA-event ms) a frame of ``n`` calls of ``frame``, after
    3 warm-up calls; each ends where the loop's last frame ended."""
    for _ in range(3):
        frame()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        frame()
    end.record()
    t1 = time.perf_counter()
    end.synchronize()
    return (t1 - t0) * 1e3 / n, start.elapsed_time(end) / n


def display_phase(scene, camera):
    """The App's display path at 1920x1080, 7 bounces (the App's
    defaults) on phase 5's scene: the conversion kernel's bytes against
    ``to_uint8`` of the same ``accum`` on the card (the frame, the frame
    stretched past [0, 1], the half steps), its device ms hot and after an
    L2 flush, its share of its bytes bound; then the App's frame body timed
    in turns with the parent's (a device clone of ``accum`` at each
    sweep's end, shown one frame later by a pageable ``.cpu()`` and the
    host's ``to_uint8``), by the host clock and CUDA events; last, from a
    profile of the new body, the copy's time and the share of it that
    overlapped other device work, and the kernel's time in frame."""
    from opengl_raytracer_torch.app import App
    from opengl_raytracer_torch.ops import _kernels, display
    from opengl_raytracer_torch.utils.image import to_uint8
    from rtbench import trace as rtrace

    app = App(scene=scene, headless=True, run=False, device=DEVICE)
    app.camPos = np.array(CAM_POS, np.float32)
    app.camDir = np.array(CAM_DIR, np.float32)
    app.resetFrames()
    held = [None]  # what the sink shows, kept until the next frame

    def keep(image, frame_count):
        held[0] = image

    new_frame = lambda: app.frame("", (0, 0), keep)
    for _ in range(4):
        new_frame()
    torch.cuda.synchronize()
    acc = app.state.accum
    k = torch.arange(255, dtype=torch.float64, device=acc.device)
    halves = ((k + 0.5) / 255.0).float()
    near = torch.cat([halves, torch.nextafter(halves, halves + 1),
                      torch.nextafter(halves, halves - 1)])
    cases = {"frame": acc, "stretched": acc * 1.7 - 0.2,
             "half_steps": near.repeat(acc.numel() // near.numel() + 1)[
                 :acc.numel()].view_as(acc).contiguous()}
    out = torch.empty(acc.shape, dtype=torch.uint8, device=acc.device)
    for name, img in cases.items():
        display.to_uint8(img, out)
        if not np.array_equal(out.cpu().numpy(), to_uint8(img.cpu().numpy())):
            raise RuntimeError(f"display {name}: the kernel's bytes differ "
                               f"from to_uint8")
    # device times from a profile: hot (the frame and bytes in L2, each
    # launch alone at the host's launch rate) and after a 128 MB flush
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=acc.device)
    with rtrace.profiler() as prof:
        for _ in range(50):
            display.to_uint8(acc, out)
        for _ in range(20):
            flush.fill_(1)
            display.to_uint8(acc, out)
        torch.cuda.synchronize()
    del flush
    alone = [(b - a) / 1e3 for n, a, b in rtrace.read(prof)[0]
             if "to_uint8_kernel" in n]
    hot, cold = float(np.median(alone[:50])), float(np.median(alone[50:]))
    least_ms = display_least_bytes(WIDTH, HEIGHT) / HBM_BYTES_S * 1e3

    r = app.renderer
    pending = []

    def old_frame():  # the parent's App frame body
        app.state = r.step(app.state, app.camera)
        if pending:
            img_dev, _ = pending.pop()
            held[0] = to_uint8(img_dev.cpu().numpy())
        pending.append((app.state.accum.clone(), app.state.frame_count))

    turns = {"parent": [], "app_frame": []}
    for name in ("parent", "app_frame", "app_frame", "parent"):
        launches = _kernels.launch_counts["to_uint8"]
        turns[name].append(_display_turn(
            old_frame if name == "parent" else new_frame, DISPLAY_FRAMES))
        pending.clear()
        want = 0 if name == "parent" else DISPLAY_FRAMES + 3
        check_count({"to_uint8": _kernels.launch_counts["to_uint8"]
                     - launches}, "to_uint8", want)

    with rtrace.profiler() as prof:
        for _ in range(8):
            new_frame()
        torch.cuda.synchronize()
    dev, _ = rtrace.read(prof)
    copies = [(a, b) for n, a, b in dev if rtrace.group(n) == "readback"]
    kernels = [b - a for n, a, b in dev if "to_uint8_kernel" in n]
    busy = rtrace.busy_intervals(
        [e for e in dev if rtrace.group(e[0]) != "readback"],
        dev[0][1], dev[-1][2])
    over = sum(max(0.0, min(b, d) - max(a, c))
               for a, b in copies for c, d in busy)
    copy_us = sum(b - a for a, b in copies)
    in_frame = sum(kernels) / len(kernels) / 1e3
    say("display", width=WIDTH, height=HEIGHT, bounces=app.config.bounces,
        exact=list(cases), kernel_hot_ms=hot, kernel_cold_ms=cold,
        kernel_in_frame_ms=in_frame, least_ms=least_ms,
        share_hot=least_ms / hot, share_cold=least_ms / cold,
        share_in_frame=least_ms / in_frame,
        parent_host_ms=[t[0] for t in turns["parent"]],
        parent_event_ms=[t[1] for t in turns["parent"]],
        app_frame_host_ms=[t[0] for t in turns["app_frame"]],
        app_frame_event_ms=[t[1] for t in turns["app_frame"]],
        copies=len(copies), copy_ms=copy_us / 1e3 / max(1, len(copies)),
        copy_overlap_share=over / copy_us if copy_us else None)


TURN_FRAMES = 200  # frames a turn of each loop in the turnaround phase
TURN_JOB = 32  # the CLI's default --frames: a job's frames from a reset


def _cli_turn(r, camera) -> tuple[float, dict]:
    """TURN_FRAMES frames of the CLI's loop on Renderer ``r`` (captured):
    jobs of TURN_JOB frames from a reset, each frame ``r.step`` then
    ``device_sync``.  The host's clock is read where the wait returns
    (``torch.cuda.synchronize``), where ``device_sync`` returns, where the
    step is called, where the graph's replay starts and returns, and where
    the step returns.  Returns (ms a frame, us a frame by part): ``read``
    from the wait's return to device_sync's, ``loop`` from there to the
    next step's call (a reset at a job's start), ``block`` from the call
    to the replay, ``replay`` the replay's call, ``turnaround`` from the
    wait's return to the replay's return (the four summed), and ``after``
    from the replay's return to the step's."""
    from opengl_raytracer_torch.utils.profiling import device_sync

    marks, sync, graph = {}, torch.cuda.synchronize, r._graph
    replay = graph.replay

    def timed_sync(*args, **kwargs):
        sync(*args, **kwargs)
        marks["wait"] = time.perf_counter()

    def timed_replay():
        marks["replay0"] = time.perf_counter()
        out = replay()
        marks["replay1"] = time.perf_counter()
        return out

    parts = {k: [] for k in ("read", "loop", "block", "replay",
                             "turnaround", "after")}
    torch.cuda.synchronize = timed_sync
    graph.replay = timed_replay
    try:
        state, prev, n = r.init_state(), None, 0
        sync()
        t_open = time.perf_counter()
        while n < TURN_FRAMES:
            state = r.reset(state)
            for _ in range(min(TURN_JOB, TURN_FRAMES - n)):
                t0 = time.perf_counter()
                state = r.step(state, camera)
                t1 = time.perf_counter()
                device_sync(state.accum)
                t2 = time.perf_counter()
                if prev is not None:
                    wait, back = prev
                    parts["read"].append(back - wait)
                    parts["loop"].append(t0 - back)
                    parts["block"].append(marks["replay0"] - t0)
                    parts["replay"].append(marks["replay1"]
                                           - marks["replay0"])
                    parts["turnaround"].append(marks["replay1"] - wait)
                parts["after"].append(t1 - marks["replay1"])
                prev = (marks["wait"], t2)
                n += 1
        ms = (time.perf_counter() - t_open) * 1e3 / TURN_FRAMES
    finally:
        torch.cuda.synchronize = sync
        del graph.replay  # the class's method again
    return ms, {k: [x * 1e6 for x in v] for k, v in parts.items()}


def turnaround_phase(scene, camera):
    """Phase 5e: the CLI frame's host turnaround, untraced, at the App's
    defaults (1920x1080, 7 bounces) on phase 5's scene: the CLI's loop
    (:func:`_cli_turn`) and ``App.frame``'s, which never waits a frame,
    TURN_FRAMES frames a turn, in turns cli, app, app, cli, on one
    renderer.  Prints each turn's ms a frame, the CLI turns' parts of the
    turnaround (median and mean us a frame), and the steps that found
    their block written ahead (``step.block_ahead_hits``; none where the
    port does not write ahead)."""
    from opengl_raytracer_torch.app import App
    from opengl_raytracer_torch.utils import profiling

    app = App(scene=scene, headless=True, run=False, device=DEVICE)
    app.camPos = np.array(CAM_POS, np.float32)
    app.camDir = np.array(CAM_DIR, np.float32)
    app.resetFrames()
    r = app.renderer
    present = lambda image, frame_count: None
    for _ in range(3):  # captures the graph, starts the display
        app.frame("", (0, 0), present)
    torch.cuda.synchronize()
    turns = {"cli": [], "app": []}
    parts = {}
    for name in ("cli", "app", "app", "cli"):
        before = profiling.counts()
        if name == "cli":
            ms, got = _cli_turn(r, app.camera)
            for k, v in got.items():
                parts.setdefault(k, []).extend(v)
        else:
            t0 = time.perf_counter()
            for _ in range(TURN_FRAMES):
                app.frame("", (0, 0), present)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / TURN_FRAMES
        ahead = {k[len("step.block_ahead_"):]: n - before.get(k, 0)
                 for k, n in profiling.counts().items()
                 if k.startswith("step.block_ahead_")}
        turns[name].append(dict(ms=ms, **ahead))
    say("turnaround", width=app.config.width, height=app.config.height,
        bounces=app.config.bounces, frames=TURN_FRAMES, job=TURN_JOB,
        cli=turns["cli"], app=turns["app"],
        us_median={k: float(np.median(v)) for k, v in parts.items()},
        us_mean={k: float(np.mean(v)) for k, v in parts.items()},
        card=repr(card_line()))


def graph_phase(cases, camera):
    """Phase 5b: the compiled step.  For each (name, scene data, traversal
    name, the traversal it must resolve to) of ``cases``: a Renderer whose
    steps replay its CUDA graph against one that runs the step's body
    eagerly, 1080p frame by frame through a script (a lambertian toggle, a
    sky change, a camera move with a reset), accum bit for bit after every
    frame; each step's host time (no device sync inside it; the graph's
    first step, which captures, left out) when each starts on an idle card;
    the peak device memory; ms/frame of 8 replayed frames issued back to
    back with each step's host time and every kernel's launches a frame,
    then of 8 eager ones."""
    from opengl_raytracer_torch import RenderConfig, Renderer, make_camera

    moved = make_camera((-30.0, 12.0, -20.0), (60.0, -20.0))
    script = [(camera, 1.0, True, False), (camera, 1.0, False, False),
              (camera, 0.6, True, False), (moved, 0.6, True, True),
              (moved, 1.0, False, False), (moved, 1.0, True, False)]
    for name, data, traversal, expect in cases:
        cfg = RenderConfig(width=WIDTH, height=HEIGHT, bounces=BOUNCES,
                           traversal=traversal)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        graphed = Renderer(data, cfg, device=DEVICE)
        eager = Renderer(data, cfg, device=DEVICE)
        if graphed.traversal != expect:
            raise RuntimeError(f"{traversal} resolved to {graphed.traversal}"
                               f" on {name}, not {expect}")
        sa, sb = graphed.init_state(), eager.init_state()
        host_g, host_e = [], []
        recon_calls = _spy_reorder()
        for k, (cam, sky, lam, reset) in enumerate(script):
            if reset:
                sa, sb = graphed.reset(sa), eager.reset(sb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sa = graphed.step(sa, cam, sky_brightness=sky, lambertian=lam)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            sb = eager._step_eager(sb, cam, sky_brightness=sky,
                                   lambertian=lam)
            t3 = time.perf_counter()
            torch.cuda.synchronize()
            if k:
                host_g.append((t1 - t0) * 1000.0)
            host_e.append((t3 - t2) * 1000.0)
            if not torch.equal(sa.accum.view(torch.int32),
                               sb.accum.view(torch.int32)):
                diff = float((sa.accum - sb.accum).abs().max())
                raise RuntimeError(f"{name} {traversal}: replayed frame {k} "
                                   f"differs from the eager body, max |d| "
                                   f"{diff}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        recon_calls = recon_calls()
        if not recon_calls or not all(recon_calls):
            raise RuntimeError(f"{name} {traversal}: the eager steps "
                               f"reordered without seed reconstruction")
        reset_counts()
        ms_g, busy_g, sa = _timed_steps(graphed.step, sa, camera)
        counts = launches()
        _check_path_counts(counts, graphed, TIMED_FRAMES)
        ms_e, busy_e, sb = _timed_steps(eager._step_eager, sb, camera)
        say("graph", scene=name, traversal=traversal,
            resolved=graphed.traversal, frames_vs_eager=len(script),
            seed_recon_reorders=len(recon_calls),
            max_abs_err=0.0, tolerance="exact (accum bit for bit)",
            host_ms_step_eager_idle=round(float(np.median(host_e)), 4),
            host_ms_step_replay_idle=round(float(np.median(host_g)), 4),
            host_ms_steps_replay_idle=[round(x, 4) for x in host_g],
            host_ms_step_eager=round(float(np.median(busy_e)), 4),
            host_ms_step_replay=round(float(np.median(busy_g)), 4),
            host_ms_steps_replay=[round(x, 4) for x in busy_g],
            ms_per_frame_replay=ms_g, ms_per_frame_eager=ms_e,
            peak_mem_gb=peak,
            launches_per_frame={k: v / TIMED_FRAMES
                                for k, v in counts.items() if v},
            card=repr(card_line()))
        del graphed, eager, sa, sb
    name, data, traversal, _ = cases[0]
    _recon_frame_check(name, data, traversal, camera)


def _spy_reorder():
    """Wrap ``permute.reorder`` until the returned function is called,
    which unwraps it and returns, for each call made meanwhile, whether it
    reconstructed the seed (a descriptor was passed)."""
    from opengl_raytracer_torch.ops import permute

    reorder, seen = permute.reorder, []

    def spy(*args):
        seen.append(args[9] is not None)
        return reorder(*args)

    permute.reorder = spy

    def done():
        permute.reorder = reorder
        return seen

    return done


def _recon_frame_check(name, data, traversal, camera) -> None:
    """One 1080p frame of ``traversal`` with seed reconstruction (the main
    path) against the same frame with the seed carried through every
    reorder (``render_pixels``'s ``_seed_recon`` off), each a replayed
    graph: accum bit for bit."""
    from opengl_raytracer_torch import RenderConfig, Renderer
    import opengl_raytracer_torch.renderer as rmod

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, bounces=BOUNCES,
                       traversal=traversal)
    images, render_pixels = [], rmod.render_pixels
    for recon in (True, False):
        r = Renderer(data, cfg, device=DEVICE)
        seen = _spy_reorder()
        if not recon:
            rmod.render_pixels = lambda *a, **k: render_pixels(
                *a, **k, _seed_recon=False)
        try:
            state = r.render(camera, frames=1)  # captures, then replays
        finally:
            rmod.render_pixels = render_pixels
            seen = seen()
        if not seen or set(seen) != {recon}:
            raise RuntimeError(f"seed_recon={recon}: the capture's "
                               f"reorders ran with {set(seen)}")
        images.append(state.accum)
    torch.cuda.synchronize()
    if not torch.equal(images[0].view(torch.int32),
                       images[1].view(torch.int32)):
        diff = float((images[0] - images[1]).abs().max())
        raise RuntimeError(f"{name} {traversal}: the frame with seed "
                           f"reconstruction differs from the carried-seed "
                           f"frame, max |d| {diff}")
    say("graph", scene=name, traversal=traversal, check="seed_recon",
        frames=1, max_abs_err=0.0,
        tolerance="exact (accum bit for bit, recon vs carried seed)",
        mean=float(images[0].mean()))


def _timed_steps(step, state, camera):
    """TIMED_FRAMES 1080p frames of ``step`` (tile_size 1: a step a frame)
    issued back to back: (ms/frame between device syncs, each step's host
    ms while the card works on the ones before it, the state)."""
    host = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        h0 = time.perf_counter()
        state = step(state, camera)
        host.append((time.perf_counter() - h0) * 1000.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0 / TIMED_FRAMES, host, state


def _cadence_config(traversal: str, sort_every: int):
    from opengl_raytracer_torch import RenderConfig

    return RenderConfig(width=WIDTH, height=HEIGHT, bounces=BOUNCES,
                        traversal=traversal, sort_every=sort_every)


def _check_path_counts(counts, r, frames: int) -> None:
    """A 1080p path's launches in ``frames`` frames of Renderer ``r``: its
    traversal's (K1 or K3 a segment), K2 a segment, the
    glue at ``r``'s cadence, and no probe."""
    check_probes(counts)
    n, parts = r.config.n_bounces, len(r.scene.k1_parts)
    k1 = r.traversal == "pallas2"
    check_count(counts, "subblock_traversal", n * frames if k1 else 0)
    check_count(counts, "wide_traversal", 0 if k1 else n * frames)
    check_count(counts, "shade", n * frames)
    check_glue(counts, r.traversal, n, frames, parts if k1 else 0,
               sort_every=r.config.sort_every)


def _equal_accum(what: str, a, b) -> None:
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        diff = float((a - b).abs().max())
        raise RuntimeError(f"{what}: accum differs, max |d| {diff}")


def cadence_phase(cases, camera):
    """Phase 5c: the reorder cadence (``RenderConfig.sort_every``).  For
    each (name, scene data, traversal name, the traversal it must resolve
    to) of ``cases``: two replayed 1080p frames at each of CADENCES, accum
    bit for bit against cadence 1, each with its cadence's launches; a
    replay at cadence 2 against the eager body; the traversal kernel (K1
    or K3) on segment 2 of a cadence-2 frame, the first one sort stale,
    bit for bit against its plain version, beside the sorted segments 1
    and 2 of a cadence-1 frame (its work, busy lanes and ms; K1's stage
    cycles from its profile build); then CADENCE_TURNS timed in turns,
    twice, CADENCE_FRAMES replayed frames a run, with the launches a
    frame."""
    from opengl_raytracer_torch import Renderer

    for name, data, traversal, expect in cases:
        renderers, ref = {}, None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in CADENCES:
            r = Renderer(data, _cadence_config(traversal, k), device=DEVICE)
            if r.traversal != expect:
                raise RuntimeError(f"{traversal} resolved to {r.traversal} "
                                   f"on {name}, not {expect}")
            reset_counts()
            state = r.render(camera, frames=2)  # captures, then replays
            torch.cuda.synchronize()
            counts = launches()
            _check_path_counts(counts, r, 2)
            ref = state.accum if ref is None else ref
            _equal_accum(f"{name} {traversal} sort_every={k} against 1",
                         state.accum, ref)
            say("cadence", scene=name, traversal=traversal, resolved=expect,
                sort_every=k, frames=2, max_abs_err=0.0,
                tolerance="exact (accum bit for bit against sort_every=1)",
                launches_per_frame={c: v / 2 for c, v in counts.items()
                                    if v})
            if k in CADENCE_TURNS:
                renderers[k] = (r, state)
        eager = Renderer(data, _cadence_config(traversal, 2), device=DEVICE)
        _equal_accum(f"{name} {traversal} sort_every=2 replay against eager",
                     renderers[2][1].accum,
                     eager_render(eager, camera, frames=2).accum)
        say("cadence", scene=name, traversal=traversal, sort_every=2,
            check="replay vs eager", frames=2, max_abs_err=0.0)
        del eager, ref
        _stale_segments(name, data, traversal, expect, camera)
        _cadence_turns(name, traversal, renderers, camera)
        del renderers


def _stale_segments(name, data, traversal, expect, camera) -> None:
    """The traversal kernel on segment 2 of a cadence-2 frame (its rays in
    the order of the reorder before segment 1, the dead among the live)
    and on the sorted segments 1 and 2 of a cadence-1 frame."""
    sorted_ = frame_segments(data, camera, traversal, expect)
    stale = frame_segments(data, camera, traversal, expect, sort_every=2)
    sets = [("sorted_b1", *sorted_[1]), ("sorted_b2", *sorted_[2]),
            ("stale_b2", *stale[2])]
    del sorted_, stale
    if expect == "pallas2":
        _k1_on_sets(name, data, sets)
    else:
        _k3_on_sets(name, data, sets)


def _k1_on_sets(name, data, sets) -> None:
    from opengl_raytracer_torch.ops import subblock_traversal as sbt
    from opengl_raytracer_torch.probes import k1 as k1_probe

    if len(data.k1_parts) != 1:
        raise RuntimeError(f"{name}: {len(data.k1_parts)} sub-block parts")
    k1 = data.k1_parts[0]
    for set_name, o3, d3, t0 in sets:
        _k1_chain_checked(f"{name} {set_name}", data, o3, d3, t0)
        *plain, _, counts = sbt._traverse_plain(*k1[:2], o3, d3, t0,
                                                counts=True)
        hits, stages = k1_probe.profile(k1, o3, d3, t0)
        if not all(torch.equal(a, b) for a, b in zip(hits, plain)):
            raise RuntimeError(f"K1 profile build differs from the plain "
                               f"walk on {name} {set_name}")
        w = k1_probe.work(counts, t0)
        ms = cuda_ms(lambda: sbt.traverse_parts(data, o3, d3, t0), 10)
        rep = k1_probe.stage_report(stages)
        say("cadence", scene=name, kernel="K1", set=set_name, rays=w["rays"],
            live=w["live"], max_abs_err=0.0, tolerance="exact", ms=ms,
            visits_per_ray=round(w["visits_per_ray"], 3),
            octets_per_ray=round(w["octets_per_ray"], 3),
            steps_per_ray=round(w["steps_per_ray"], 3),
            lanes_steps=round(w["lanes_steps"], 4),
            lanes_visits=round(w["lanes_visits"], 4),
            lanes_octets=round(w["lanes_octets"], 4),
            cycles_share={s: round(rep[s]["share"], 3)
                          for s in k1_probe.STAGES},
            gcycles=round(sum(rep[s]["cycles"] for s in k1_probe.STAGES)
                          / 1e9, 3))


def _k3_on_sets(name, data, sets) -> None:
    from opengl_raytracer_torch.ops import pallas_traversal as wide
    from opengl_raytracer_torch.probes import k3 as k3_probe

    stack = wide.stack_size(data.pw_max_stack)
    ov = wide.overflow_tensor(data.device)
    for set_name, o3, d3, t0 in sets:
        ov.zero_()
        kernel = wide.traverse_wide(data, o3, d3, t0)
        *plain, dropped, counts = wide._traverse_plain(
            *data.k3, o3, d3, t0, stack, counts=True)
        if int(ov.item()) or int(dropped):
            raise RuntimeError(f"K3 overflow on {name} {set_name}")
        for field, a, b in zip(("t", "slot", "u", "v"), kernel, plain):
            if not torch.equal(a, b):
                diff = (a.double() - b.double()).abs().max()
                raise RuntimeError(f"K3 {field} differs from the plain "
                                   f"version on {name} {set_name}: max |d| "
                                   f"{diff}")
        w = k3_probe.work(counts, t0)
        ms = cuda_ms(lambda: wide.traverse_wide(data, o3, d3, t0), 10)
        say("cadence", scene=name, kernel="K3", set=set_name, rays=w["rays"],
            live=w["live"], max_abs_err=0.0, tolerance="exact", ms=ms,
            visits_per_ray=round(w["visits_per_ray"], 3),
            octets_per_ray=round(w["octets_per_ray"], 3),
            lanes_steps=round(w["lanes_steps"], 4),
            lanes_visits=round(w["lanes_visits"], 4),
            lanes_leaves=round(w["lanes_leaves"], 4))


def _cadence_turns(name, traversal, renderers, camera) -> None:
    """CADENCE_TURNS in turns, twice: CADENCE_FRAMES replayed frames a run,
    timed between device syncs, their launches read just after."""

    runs = {k: [] for k in CADENCE_TURNS}
    for k in CADENCE_TURNS * 2:
        r, state = renderers[k]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state = r.render(camera, frames=CADENCE_FRAMES, state=state)
        torch.cuda.synchronize()
        runs[k].append((time.perf_counter() - t0) * 1000.0 / CADENCE_FRAMES)
        counts = launches()
        _check_path_counts(counts, r, CADENCE_FRAMES)
        renderers[k] = (r, state)
    for k in CADENCE_TURNS:
        say("cadence", scene=name, traversal=traversal, sort_every=k,
            frames=CADENCE_FRAMES, ms_per_frame_runs=runs[k],
            ms_per_frame=min(runs[k]),
            sorts_a_frame=sorts_a_raytrace(BOUNCES + 1, k),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            card=repr(card_line()))


PROFILE_TRIES = 3  # the profiler now and then misses a few launches


def cadence_profile_phase(cases, camera) -> None:
    """Phase 11c: phase 11's group split of replayed frames at each of
    CADENCE_TURNS for phase 5c's ``cases``, with the traversal's ms by
    segment: primary (segment 0), sorted (a reorder just before it) or
    stale.  A profile that missed a traversal launch is taken again, up to
    PROFILE_TRIES times."""
    from opengl_raytracer_torch import Renderer

    for name, data, traversal, _ in cases:
        for k in CADENCE_TURNS:
            r = Renderer(data, _cadence_config(traversal, k), device=DEVICE)
            state = r.render(camera, frames=2)  # warm-up
            torch.cuda.synchronize()
            n, f = r.config.n_bounces, PROFILED_FRAMES
            for tries in range(1, PROFILE_TRIES + 1):
                source, events, _ = _profiled_events(r, camera, state)
                trav = [e for e in events
                        if _kernel_group(e[0]) in ("K1", "K3")]
                if len(trav) == n * f:
                    break
            else:
                raise RuntimeError(f"{name} sort_every={k}: the profiler saw "
                                   f"{len(trav)} traversal launches in {f} "
                                   f"frames, expected {n * f}")
            seg_ms = [0.0] * n
            for j, (_, t0, t1) in enumerate(trav):
                seg_ms[j % n] += (t1 - t0) / 1e3 / f
            kind = ["primary"] + ["sorted" if (i - 1) % k == 0 else "stale"
                                  for i in range(1, n)]
            groups = {}
            for kname, t0, t1 in events:
                g = groups.setdefault(_kernel_group(kname), [0.0, 0])
                g[0] += (t1 - t0) / 1e3 / f
                g[1] += 1 / f
            said = {g: [round(v[0], 4), v[1]] for g, v in sorted(
                groups.items(), key=lambda kv: -kv[1][0])}
            mean = {c: float(np.mean([m for m, x in zip(seg_ms, kind)
                                      if x == c]))
                    for c in set(kind)}
            say("cadence_profile", scene=name, traversal=r.traversal,
                sort_every=k, profiled=source, frames=f, tries=tries,
                traversal_ms_by_segment=[round(m, 4) for m in seg_ms],
                segments=kind, traversal_ms_a_segment={
                    c: round(m, 4) for c, m in mean.items()},
                device_ms_per_frame=round(sum(v[0] for v in groups.values()),
                                          4),
                groups_ms_and_launches_per_frame=said)


def _kernel_group(name: str) -> str:
    n = name.lower()
    for group, keys in (("G1 ray front", ("ray_front_kernel",)),
                        ("G5 K3 prologue/epilogue", ("wide_prologue",
                                                     "wide_epilogue")),
                        ("G6 band fold", ("band_fold",)),
                        ("block write", ("write_block",)),
                        ("G2 sort keys", ("coherence_key_kernel",)),
                        ("G3 reorder index pass", ("reorder_index_kernel",)),
                        ("G3 reorder gather", ("reorder_kernel",)),
                        ("G3 restore", ("restore_kernel",)),
                        ("G7 bvh walk", ("bvh_walk",)),
                        ("G8 brute sweep", ("brute_sweep",)),
                        ("G9 packet walk", ("packet_walk",)),
                        ("K3", ("wide_traverse",)), ("K1", ("traverse",)),
                        ("K2", ("shade_kernel",)), ("sort", ("radix", "sort")),
                        ("copy", ("memcpy", "memset")),
                        ("gather/scatter", ("gather", "scatter", "index"))):
        if any(k in n for k in keys):
            return group
    return "other torch kernels"


def _device_events(prof):
    """(name, start us, end us) of every kernel, copy and set the profiler
    saw on the card."""
    cuda = torch.autograd.DeviceType.CUDA
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.device_type == cuda]
    if not out:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                start = e.start_ns() / 1e3
                out.append((e.name(), start, start + e.duration_ns() / 1e3))
    return out


TRAVERSAL_GROUPS = ("K1", "K3", "G7 bvh walk", "G8 brute sweep",
                    "G9 packet walk")


def frame_profile_phase(scenes, camera):
    """torch.profiler over PROFILED_FRAMES 1080p frames of each of
    ``scenes`` ((name, scene, unprofiled ms/frame of its phase, traversal
    name)): device ms and launches per frame by kernel group, and the
    device's busy share and idle share of the unprofiled ms/frame."""
    for name, scene, main_ms, traversal in scenes:
        _profile_frames(name, scene, camera, main_ms, traversal)


def partial_eager(r):
    """``r.render``'s signature over :func:`eager_render`."""
    return lambda camera, frames, state: eager_render(r, camera, frames,
                                                      state)


def _profiled_events(r, camera, state):
    """PROFILED_FRAMES frames of Renderer ``r`` under torch.profiler (card
    activity only): (what was profiled, the card's events in time order,
    wall ms).  The replays' kernels, if the profiler sees inside a graph;
    else the eager body's, which launches the same kernels one by one."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for source, frames in (("replay", r.render), ("eager body",
                                                  partial_eager(r))):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            frames(camera, frames=PROFILED_FRAMES, state=state)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1000.0
        events = sorted(_device_events(prof), key=lambda e: e[1])
        if any(_kernel_group(e[0]) in TRAVERSAL_GROUPS for e in events):
            break
    if not events:
        raise RuntimeError("the profiler saw no work on the card")
    return source, events, wall_ms


def _profile_frames(name, scene, camera, main_ms, traversal="auto"):
    from opengl_raytracer_torch import RenderConfig, Renderer

    r = Renderer(scene, RenderConfig(width=WIDTH, height=HEIGHT,
                                     bounces=BOUNCES, traversal=traversal),
                 device=DEVICE)
    state = r.render(camera, frames=2)  # warm-up
    torch.cuda.synchronize()
    source, events, wall_ms = _profiled_events(r, camera, state)
    groups = {}
    busy, end = 0.0, float("-inf")
    for kname, t0, t1 in events:
        g = groups.setdefault(_kernel_group(kname), [0.0, 0])
        g[0] += t1 - t0
        g[1] += 1
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    f = PROFILED_FRAMES
    busy_ms = busy / 1e3 / f
    unsorted = {"sort", "G2 sort keys", "G3 reorder index pass",
                "G3 reorder gather", "G3 restore"} & set(groups)
    if r.traversal in ("brute", "bvh") and unsorted:
        raise RuntimeError(f"{name} {r.traversal} ran {sorted(unsorted)}: "
                           f"the path does not reorder")
    say("profile", scene=name, traversal=r.traversal, frames=f,
        profiled=source, profiled_wall_ms_per_frame=wall_ms / f,
        unprofiled_ms_per_frame=main_ms, device_busy_ms_per_frame=busy_ms,
        idle_share=1.0 - busy_ms / main_ms, card=repr(card_line()))
    for g, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        say("profile", scene=name, group=repr(g), ms_per_frame=us / 1e3 / f,
            launches_per_frame=n / f, share_of_frame=us / 1e3 / f / main_ms)


def wide_path_phase(scene, camera, main_img):
    """The K3 path: "pallas" at 1080p; returns its launch counts."""
    from opengl_raytracer_torch.utils.image import rmse

    r, img, counts, ms = render_1080p(scene, camera, "pallas")
    frames = 1 + TIMED_FRAMES
    check_count(counts, "wide_traversal", r.config.n_bounces * frames)
    check_count(counts, "shade", r.config.n_bounces * frames)
    check_count(counts, "subblock_traversal", 0)
    check_glue(counts, r.traversal, r.config.n_bounces, frames)
    # the same seeds as phase 5's frames: only exact-t ties may differ
    err = rmse(img, main_img)
    if err > 1e-3:
        raise RuntimeError(f"pallas 1080p image vs pallas2's: rmse {err} "
                           f"(limit 1e-3)")
    say("pallas", width=WIDTH, height=HEIGHT, bounces=BOUNCES,
        ms_per_frame=ms, fps=1000.0 / ms, frames=frames,
        k3_launches=counts["wide_traversal"], k2_launches=counts["shade"],
        k1_launches=counts["subblock_traversal"], mean=float(img.mean()),
        rmse_vs_pallas2=err, limit=1e-3,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    card_vs_cpu(scene, camera, "pallas")
    return counts


def big_phase(scene, data, camera):
    """Phase 4c: the 1,964,180-triangle scene under "auto", which must run
    K3 ("pallas"): 1 warm-up and BIG_FRAMES timed 1080p frames, their
    launch counts and peak memory, and the 96x54 card-vs-CPU check;
    returns the launch counts and ms/frame."""
    torch.cuda.reset_peak_memory_stats()
    r, img, counts, ms = render_1080p(data, camera, "auto", BIG_FRAMES)
    if r.traversal != "pallas":
        raise RuntimeError(f"auto resolved to {r.traversal} on the big "
                           f"scene, not pallas")
    frames = 1 + BIG_FRAMES
    check_count(counts, "wide_traversal", r.config.n_bounces * frames)
    check_count(counts, "shade", r.config.n_bounces * frames)
    check_count(counts, "subblock_traversal", 0)
    check_glue(counts, r.traversal, r.config.n_bounces, frames)
    say("big", triangles=scene.total_triangles, width=WIDTH, height=HEIGHT,
        bounces=BOUNCES, traversal=r.traversal, ms_per_frame=ms,
        fps=1000.0 / ms, frames=frames, k3_launches=counts["wide_traversal"],
        k2_launches=counts["shade"],
        k1_launches=counts["subblock_traversal"], mean=float(img.mean()),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        card=repr(card_line()))
    card_vs_cpu(scene, camera, "auto")
    return counts, ms


def k2probe_phase(seed: int, k2_ms: float):
    """Phase 4d: the two row-fetch sums of probes/k2.py against their plain
    version, bit for bit; their ms and bytes bound beside K2's."""
    from opengl_raytracer_torch.ops import _kernels
    from opengl_raytracer_torch.probes import k2 as k2_probe

    R, S = k2_probe.R_PROBE, k2_probe.S_PROBE
    table, table_t, slots = k2_probe.probe_inputs(seed, device=DEVICE)
    before = _kernels.launch_counts["k2_probe"]
    rows = k2_probe.rows_sum(table, slots)
    cols = k2_probe.cols_sum(table_t, slots)
    plain = k2_probe.sum_plain(table[slots.long()].unbind(1))
    for name, got in (("rows", rows), ("cols", cols)):
        if not torch.equal(got, plain):
            raise RuntimeError(f"K2 probe {name} sum differs from the plain "
                               f"version: max |d| "
                               f"{float((got - plain).abs().max())}")
    iters = 20
    ms_rows = cuda_ms(lambda: k2_probe.rows_sum(table, slots), iters)
    ms_cols = cuda_ms(lambda: k2_probe.cols_sum(table_t, slots), iters)
    plain_ms = cuda_ms(lambda: k2_probe.sum_plain(
        table[slots.long()].unbind(1)), 3)
    launched = _kernels.launch_counts["k2_probe"] - before
    if launched != 2 * (2 + iters):
        raise RuntimeError(f"k2_probe launched {launched} times")
    bound, by = bound_ms(k2_probe.bytes_moved(R, S), R * 46)
    say("k2probe", rays=R, rows=S, rows_sum_ms=ms_rows, cols_sum_ms=ms_cols,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        share_of_bound_rows=bound / ms_rows, k2_ms=k2_ms,
        rows_sum_share_of_k2=ms_rows / k2_ms, max_abs_err=0.0,
        tolerance="exact", card=repr(card_line()))


def small_paths_phase(scene, camera):
    """The small-scene traversals.  The reference's box without its meshes
    (84 triangles) on the card and the CPU at 96x54: "auto" (which
    resolves to brute force, G8), "bvh" (G7) and "packet" (G9).  Then
    1080p frames, each step a graph replay: the box under "auto" and
    "bvh", and standin-31k ``scene`` under "bvh" (G7 at a real tree
    depth), each 1 warm-up and TIMED_FRAMES timed frames with the launches
    checked (G8 or G7, K2 5 a frame, G1 and G6 1, no G2, G3, K1 or K3).
    Returns ({counter: launches} of G8 and G7 in the box's 1080p frames,
    {(scene, traversal): ms/frame})."""
    from opengl_raytracer_torch import RenderConfig

    box, _ = demo_box(DEVICE)
    n = RenderConfig(bounces=BOUNCES).n_bounces
    for traversal, expect in (("auto", "brute"), ("bvh", "bvh"),
                              ("packet", "packet")):
        got, counts = card_vs_cpu(box, camera, traversal)
        if got != expect:
            raise RuntimeError(f"{traversal} resolved to {got}, not {expect}")
        for k in ("subblock_traversal", "wide_traversal"):
            check_count(counts, k, 0)
        check_glue(counts, got, n, 1)
        say("small", traversal=traversal, resolved=got,
            k3_launches=counts["wide_traversal"],
            k2_launches=counts["shade"], g7_launches=counts["bvh_walk"],
            g8_launches=counts["brute_sweep"],
            g9_launches=counts["packet_walk"],
            g5_launches=counts["wide_epilogue"])
    launches, frame_ms = {}, {}
    frames = 1 + TIMED_FRAMES
    for name, sc, traversal, expect in (
            ("box", box, "auto", "brute"), ("box", box, "bvh", "bvh"),
            ("standin-31k", scene, "bvh", "bvh")):
        r, img, counts, ms = render_1080p(sc, camera, traversal)
        if r.traversal != expect:
            raise RuntimeError(f"{name} {traversal} resolved to "
                               f"{r.traversal}, not {expect}")
        for k in ("subblock_traversal", "wide_traversal"):
            check_count(counts, k, 0)
        check_count(counts, "shade", n * frames)
        check_glue(counts, r.traversal, n, frames)
        counter = "brute_sweep" if expect == "brute" else "bvh_walk"
        if name == "box":
            launches[counter] = counts[counter]
        frame_ms[name, traversal] = ms
        say("small", scene=name, triangles=r.scene.num_tris,
            traversal=traversal, resolved=r.traversal, width=WIDTH,
            height=HEIGHT, bounces=BOUNCES, frames=frames,
            ms_per_frame=ms, fps=1000.0 / ms,
            **{f"{k}_launches": counts[k] for k in (
                "brute_sweep", "bvh_walk", "shade", "ray_front",
                "band_fold", "sort_keys", "reorder", "restore")},
            mean=float(img.mean()), card=repr(card_line()))
        del r
    return launches, frame_ms


def packet_phase(scene, big, camera, main_img):
    """Phase 7b: the "packet" traversal (G9) at 1920x1080 / 4 bounces,
    its rays in 8x16 blocks (1080 and 1920 are whole blocks): 1 warm-up
    and TIMED_FRAMES timed replayed frames of standin-31k ``scene`` and of
    standin-1.96m ``big``, each with G9 and K2 5 a frame, the reorder's
    glue, no K1, K3 or G5; the standin-31k image against "auto"'s
    (``main_img``: the same seeds, so only exact-t ties and rays in box
    face planes may differ); two replayed frames against the eager body,
    bit for bit; and frames on the card and the CPU at 96x54 (not
    blocked: 54 rows) and 96x48 (blocked).  Returns (standin-31k's launch
    counts, {scene: ms/frame})."""
    from opengl_raytracer_torch import RenderConfig, Renderer
    from opengl_raytracer_torch.renderer import packet_blocks
    from opengl_raytracer_torch.utils.image import rmse

    frames = 1 + TIMED_FRAMES
    out_counts, frame_ms = None, {}
    for name, sc in (("standin-31k", scene), ("standin-1.96m", big)):
        r, img, counts, ms = render_1080p(sc, camera, "packet")
        if r.traversal != "packet" or not packet_blocks(r.config, "packet"):
            raise RuntimeError(f"{name} packet: {r.traversal}, blocks "
                               f"{packet_blocks(r.config, 'packet')}")
        n = r.config.n_bounces
        for k in ("subblock_traversal", "wide_traversal"):
            check_count(counts, k, 0)
        check_count(counts, "shade", n * frames)
        check_glue(counts, "packet", n, frames)
        extra = {}
        if out_counts is None:
            out_counts = counts
            extra = dict(rmse_vs_auto=rmse(img, main_img), limit=1e-3)
            if extra["rmse_vs_auto"] > 1e-3:
                raise RuntimeError(f"packet 1080p image vs auto's: {extra}")
        frame_ms[name] = ms
        say("packet", scene=name, triangles=r.scene.num_tris, width=WIDTH,
            height=HEIGHT, bounces=BOUNCES, frames=frames, ms_per_frame=ms,
            fps=1000.0 / ms, **{f"{k}_launches": counts[k] for k in (
                "packet_walk", "shade", "wide_traversal",
                "subblock_traversal", "wide_epilogue", "ray_front",
                "sort_keys", "reorder", "restore", "band_fold")},
            mean=float(img.mean()), **extra, card=repr(card_line()))
        del r
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, bounces=BOUNCES,
                       traversal="packet")
    graphed = Renderer(scene, cfg, device=DEVICE)
    eager = Renderer(scene, cfg, device=DEVICE)
    sa, sb = graphed.init_state(), eager.init_state()
    for k in range(2):
        sa = graphed.step(sa, camera)
        sb = eager._step_eager(sb, camera)
        torch.cuda.synchronize()
        if not torch.equal(sa.accum.view(torch.int32),
                           sb.accum.view(torch.int32)):
            raise RuntimeError(f"packet: replayed frame {k} differs from "
                               f"the eager body")
    say("packet", scene="standin-31k", check="replay vs eager", frames=2,
        max_abs_err=0.0, tolerance="exact (accum bit for bit)")
    del graphed, eager, sa, sb
    for size in (SMALL, (96, 48)):
        card_vs_cpu(scene, camera, "packet", size=size)
    return out_counts, frame_ms


def multipart_phase(camera):
    from opengl_raytracer_torch import RenderConfig, Renderer
    from opengl_raytracer_torch.models import scene as scene_mod

    orig = scene_mod.build_subblock_parts  # split at its defaults
    scene_mod.build_subblock_parts = lambda *a, **k: orig(
        *a, stats=k.get("stats"))
    try:
        scene, data = make_scene(150, 300, DEVICE)
    finally:
        scene_mod.build_subblock_parts = orig
    parts = len(data.k1_parts)
    if parts != 4:
        raise RuntimeError(f"multi-part scene split into {parts} parts, "
                           f"expected 4")
    from opengl_raytracer_torch.ops import subblock_traversal as sbt
    from opengl_raytracer_torch.probes import k1 as k1_probe

    tables = [x for part in data.k1_parts for x in part]
    chain_ms = 0.0
    for i, (o3, d3, t0) in enumerate(frame_segments(data, camera)):
        _, work = _k1_chain_checked(f"the 4-part chain's segment {i}", data,
                                    o3, d3, t0)
        w = k1_probe.work(work, t0)
        ops, n_bytes, bound, by = k1_bound(w, tables)
        ms = cuda_ms(lambda: sbt.traverse_parts(data, o3, d3, t0), 10)
        chain_ms += ms
        say("multipart", kernel="K1 chain", set=f"frame_b{i}", parts=parts,
            rays=w["rays"], live=w["live"], max_abs_err=0.0, ms=ms,
            steps_per_ray=round(w["steps_per_ray"], 3),
            lanes_steps=round(w["lanes_steps"], 4),
            gops=round(ops / 1e9, 4), mbytes=round(n_bytes / 1e6, 3),
            bound_ms=round(bound, 5), bound_by=by,
            share_of_bound=round(bound / ms, 4))
    say("multipart", kernel="K1 chain", frame_ms=chain_ms,
        tolerance="exact (t, tri, u, v, slot bit for bit)")
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, bounces=BOUNCES)
    r = Renderer(data, cfg, device=DEVICE)
    state = r.render(camera, frames=1)  # warm-up
    reset_counts()
    frames_ms = []
    for _ in range(MULTIPART_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = r.render(camera, frames=1, state=state)
        torch.cuda.synchronize()
        frames_ms.append((time.perf_counter() - t0) * 1000.0)
    counts = launches()
    check_probes(counts)
    check_count(counts, "subblock_traversal", cfg.n_bounces * MULTIPART_FRAMES)
    check_count(counts, "shade", cfg.n_bounces * MULTIPART_FRAMES)
    check_glue(counts, r.traversal, cfg.n_bounces, MULTIPART_FRAMES, parts)
    img = r.image(state)
    if not np.isfinite(img).all():
        raise RuntimeError("multi-part image holds non-finite values")
    say("multipart", triangles=scene.total_triangles, parts=parts,
        ms_per_frame=sum(frames_ms) / len(frames_ms), frames_ms=frames_ms,
        k1_launches=counts["subblock_traversal"],
        k2_launches=counts["shade"], mean=float(img.mean()))


class _Tee(io.TextIOBase):
    """Writes through to ``out`` and keeps a copy of the text."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def write_standin_objs(root: str):
    """Phase 5's stand-in meshes in their object frames as the default
    scene's OBJ files under ``root``: Mesh's bake (scale 0.25 about [-5,
    -10, 0]; scale 7 about [-25, -20, 20]) places them where phase 5's
    Triangles lie.  Returns (dragon, sphere) paths."""
    dragon = os.path.join(root, "stanford_minidragon", "dragon.obj")
    sphere = os.path.join(root, "sphere", "sphere.obj")
    write_lat_long_obj(dragon, lambda t, p: 36.0 * _bumpy(t, p), 83, 166,
                       smooth=False)
    write_lat_long_obj(sphere, lambda t, p: np.ones_like(t), 32, 64,
                       smooth=True)
    return dragon, sphere


def cli_phase():
    """The user's entry point on the reference's default scene, loaded from
    OBJ files: ``presets.default_scene()``, two CLI runs at 1080p (4
    frames, then 4 more resumed from the checkpoint), the resumed image
    against 8 straight frames of ``App``, the PNG round trip, and a 96x54
    ``App`` frame on the card against the CPU.  Returns the 8 straight
    frames' image."""
    import contextlib
    import re
    import tempfile

    from opengl_raytracer_torch import __main__ as cli
    from opengl_raytracer_torch import app as app_mod
    from opengl_raytracer_torch import presets
    from opengl_raytracer_torch.models import obj
    from opengl_raytracer_torch.ops import bvh
    from opengl_raytracer_torch.utils.image import load_png, rmse, to_uint8

    torch.cuda.reset_peak_memory_stats()
    saved_env = os.environ.get("OGLRT_MODELS_PATH")
    App = app_mod.App
    with tempfile.TemporaryDirectory() as tmp:
        dragon, sphere = write_standin_objs(tmp)
        os.environ["OGLRT_MODELS_PATH"] = tmp
        try:
            t0 = time.perf_counter()
            for path in (dragon, sphere):
                obj.load_obj(path)
            parse_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            scene = presets.default_scene()
            scene_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            data = scene.send(DEVICE)
            tables_s = time.perf_counter() - t0
            if (scene.total_triangles != 27556 + 4096 + 84
                    or len(data.k1_parts) != 1):
                raise RuntimeError(
                    f"OBJ-loaded default scene: {scene.total_triangles} "
                    f"triangles in {len(data.k1_parts)} parts, expected 31736 "
                    f"in 1")
            if obj.last_parser != "native" or bvh.last_builder != "native":
                raise RuntimeError(f"parser {obj.last_parser}, BVH builder "
                                   f"{bvh.last_builder}: expected native")
            say("cli", triangles=scene.total_triangles,
                parts=len(data.k1_parts), parser=obj.last_parser,
                bvh_builder=bvh.last_builder,
                obj_parse_s=f"{parse_s:.3f}",
                default_scene_s=f"{scene_s:.3f}",
                tables_upload_s=f"{tables_s:.3f}")

            png = os.path.join(tmp, "cli.png")
            argv = ["--width", str(WIDTH), "--height", str(HEIGHT),
                    "--bounces", str(BOUNCES), "--frames", "4", "--out", png,
                    "--checkpoint", os.path.join(tmp, "ck.npz")]
            apps = []

            class Recorded(App):  # the App each CLI call builds
                def main(self):
                    apps.append(self)
                    super().main()

            app_mod.App = Recorded
            for call in (1, 2):
                reset_counts()
                tee = _Tee(sys.stdout)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(tee):
                    rc = cli.main(argv)
                torch.cuda.synchronize()
                call_s = time.perf_counter() - t0
                counts = launches()
                check_probes(counts)
                a = apps[-1]
                if rc != 0 or a.device.type != torch.device(DEVICE).type:
                    raise RuntimeError(f"CLI call {call}: rc {rc} on "
                                       f"{a.device}")
                if a.renderer.traversal != "pallas2":
                    raise RuntimeError(f"CLI: auto resolved to "
                                       f"{a.renderer.traversal}, not pallas2")
                if a.state.frame_count != 4 * call:
                    raise RuntimeError(f"CLI call {call} ended at frame "
                                       f"{a.state.frame_count}")
                parts = len(a.renderer.scene.k1_parts)
                n = a.config.n_bounces
                check_count(counts, "subblock_traversal", n * 4)
                check_count(counts, "shade", n * 4)
                check_count(counts, "wide_traversal", 0)
                check_glue(counts, "pallas2", n, 4, parts)
                frame_ms = [int(m) for m in re.findall(
                    r"Frame \d+\s+(\d+) ms", "".join(tee.parts))]
                print()
                say("cli", call=call, traversal=a.renderer.traversal,
                    frames=f"{4 * call - 3}-{4 * call}",
                    cli_ms_per_frame=frame_ms, call_s=f"{call_s:.3f}",
                    k1_launches=counts["subblock_traversal"],
                    k2_launches=counts["shade"],
                    k3_launches=counts["wide_traversal"])
            app_mod.App = App
            img = apps[-1].image()

            straight = App(window_size=(WIDTH, HEIGHT), bounces=BOUNCES,
                           headless=True, max_frames=8, device=DEVICE,
                           output=os.path.join(tmp, "straight.png"))
            err = rmse(img, straight.image())
            if not np.isfinite(img).all() or err > 1e-7:
                raise RuntimeError(f"resumed CLI image vs 8 straight frames: "
                                   f"rmse {err} (limit 1e-7)")
            decoded = np.round(load_png(png) * 255.0).astype(np.uint8)
            if not np.array_equal(decoded, to_uint8(img)):
                raise RuntimeError("the CLI's PNG differs from to_uint8 of "
                                   "its image")
            say("cli", resumed_vs_straight_rmse=err, limit=1e-7,
                png_round_trip="exact", mean=float(img.mean()),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

            small = []
            for device in (DEVICE, "cpu"):
                a = App(window_size=SMALL, bounces=BOUNCES, scene=scene,
                        headless=True, max_frames=1, device=device,
                        output=os.path.join(tmp, f"small_{device}.png"))
                small.append(a.image())
            err = rmse(small[0], small[1])
            if not (np.isfinite(small[0]).all()
                    and float(small[0].mean()) > 0.01 and err < 1e-4):
                raise RuntimeError(f"App {SMALL[0]}x{SMALL[1]}: card vs CPU "
                                   f"rmse {err} (limit 1e-4), mean "
                                   f"{small[0].mean()}")
            say("cli", width=SMALL[0], height=SMALL[1],
                rmse_card_vs_cpu=err, limit=1e-4)
            return straight.image()
        finally:
            app_mod.App = App
            if saved_env is None:
                os.environ.pop("OGLRT_MODELS_PATH", None)
            else:
                os.environ["OGLRT_MODELS_PATH"] = saved_env


def _home_card_bytes(devices, rows: int, tw: int) -> int:
    """The bytes a mesh step copied when ``accum`` lived on
    ``devices[0, 0]``: each shard's colours, ``rows`` band rows, to it."""
    home = devices[0, 0]
    return int(sum(d != home for d in devices.flat)) * rows * tw * 12


def _sp_copy_bytes(devices, rows: int, tw: int) -> int:
    """The bytes a mesh step of a band that is the whole frame copies:
    each dp row's sp shards on another device than the row's first send it
    their ``rows`` band rows; each dp row's piece is its own slice."""
    return int(sum(d != row[0] for row in devices for d in row[1:])) \
        * rows * tw * 12


def _check_slices(sr, cfg, dp: int) -> None:
    """The state's ``accum`` is dp slices of (H/dp, W, 3) float32, slice j
    on the mesh's devices[j, 0]."""
    from opengl_raytracer_torch.parallel import RowShardedAccum

    accum = sr.init_state().accum
    shape = (cfg.height // dp, cfg.width, 3)
    got = [(tuple(s.shape), s.dtype, s.device) for s in accum.slices]
    want = [(shape, torch.float32, dev) for dev in sr.mesh.devices[:, 0]]
    if not isinstance(accum, RowShardedAccum) or got != want:
        raise RuntimeError(f"mesh {dp}x{sr.mesh.shape['sp']}: accum slices "
                           f"{got}, expected {want}")


def _sharded_api(scene, camera, card: str, cards: int = 1) -> None:
    """Phase 10's meshes of the one card repeated (``cards`` 1) or of
    cards ``cuda:0 ..`` (``cards`` 4: each shard on a card of its own),
    each one sweep of sp frames against the sequential Renderer at sp
    frames, its slices and its copies checked, then timed; on real cards
    also the copies a step makes between cards."""
    from opengl_raytracer_torch import RenderConfig, Renderer
    from opengl_raytracer_torch.parallel import ShardedRenderer, make_mesh
    from opengl_raytracer_torch.parallel import sharding
    from opengl_raytracer_torch.utils.image import rmse

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, bounces=BOUNCES)
    seq = Renderer(scene, cfg, device=DEVICE)
    state = seq.init_state()
    seq_at = {}
    for f in (1, 2):
        state = seq.render(camera, frames=1, state=state)
        seq_at[f] = seq.image(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq.render(camera, frames=SHARD_SWEEPS, state=state)
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1000.0 / SHARD_SWEEPS
    say("sharded", mesh="sequential", ms_per_frame=seq_ms, card=repr(card))

    enqueue = []
    plain_run = sharding._Shard.run

    def timed_run(self, *args, **kw):  # one shard's host time a step
        t0 = time.perf_counter()
        out = plain_run(self, *args, **kw)
        enqueue.append((time.perf_counter() - t0) * 1000.0)
        return out

    for dp, sp in MESHES:
        devices = ([DEVICE] * (dp * sp) if cards == 1
                   else [f"cuda:{k}" for k in range(dp * sp)])
        mesh = make_mesh(devices=devices, dp=dp, sp=sp)
        sr = ShardedRenderer(scene, cfg, mesh)
        if sr.traversal != "pallas2" or len(sr.scenes) != len(set(devices)):
            raise RuntimeError(f"mesh {dp}x{sp}: auto resolved to "
                               f"{sr.traversal}, scene on {list(sr.scenes)}")
        parts = len(sr.scene.k1_parts)
        _check_slices(sr, cfg, dp)
        reset_counts()
        state = sr.render(camera, frames=sp)
        torch.cuda.synchronize()
        counts = launches()
        check_probes(counts)
        check_count(counts, "subblock_traversal", cfg.n_bounces * dp * sp)
        check_count(counts, "shade", cfg.n_bounces * dp * sp)
        check_count(counts, "wide_traversal", 0)
        # the band is the whole frame: dp row i's piece is slice i, one
        # fold and one block write a slice
        check_glue(counts, sr.traversal, cfg.n_bounces, dp * sp, parts,
                   steps=1, blocks=dp * sp + dp + counts["block_misses"],
                   folds=dp)
        # ... so a step copies only each dp row's sp shards to its first
        # device
        rows, tw = cfg.tile_h // dp, cfg.tile_w
        distinct = np.arange(dp * sp).reshape(dp, sp)
        expected = _sp_copy_bytes(mesh.devices, rows, tw)
        home_rule = _home_card_bytes(mesh.devices, rows, tw)
        if sr.moved_bytes != expected or expected > home_rule:
            raise RuntimeError(f"mesh {dp}x{sp}: a step copied "
                               f"{sr.moved_bytes} B, expected {expected}, "
                               f"{home_rule} with accum on one card")
        img = sr.image(state)
        err = rmse(img, seq_at[sp])
        if not np.isfinite(img).all() or err > 1e-6:
            raise RuntimeError(f"mesh {dp}x{sp} vs the sequential render at "
                               f"{sp} frames: rmse {err} (limit 1e-6)")
        enqueue.clear()
        host = []
        moved = sr.moved_bytes
        sharding._Shard.run = timed_run
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SHARD_SWEEPS):  # one step a sweep of sp frames
                h0 = time.perf_counter()
                state = sr.step(state, camera)
                host.append((time.perf_counter() - h0) * 1000.0)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        finally:
            sharding._Shard.run = plain_run
        moved = (sr.moved_bytes - moved) // SHARD_SWEEPS
        if cards > 1 and dp * sp > 1:
            _peer_copy(sr, state, camera, dp, sp, card)
        say("sharded", mesh=f"{dp}x{sp}", cards=len(set(devices)),
            traversal=sr.traversal, bytes_moved_a_step=moved,
            bytes_a_step_on_distinct_cards=_sp_copy_bytes(distinct, rows, tw),
            home_card_bytes_a_step=home_rule,
            home_card_bytes_on_distinct_cards=_home_card_bytes(distinct, rows,
                                                               tw),
            k1_launches=counts["subblock_traversal"],
            k2_launches=counts["shade"], k3_launches=counts["wide_traversal"],
            rmse_vs_sequential=err, limit=1e-6,
            max_abs=float(np.abs(img - seq_at[sp]).max()),
            ms_per_frame=sec * 1000.0 / (sp * SHARD_SWEEPS),
            host_ms_per_shard=[round(x, 4) for x in enqueue],
            host_ms_shard_median=float(np.median(enqueue)),
            host_ms_per_step=[round(x, 4) for x in host], card=repr(card))


def _sync_all() -> None:
    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)


def _peer_copy(sr, state, camera, dp: int, sp: int, card: str) -> None:
    """The copies one mesh step makes between cards (a dp row's sp shards
    to its sp=0 card, and a run of rows to the card of the slice that
    holds it), recorded in one more step, then all made again: ms a step's
    copies on the host clock between syncs of every card, and the rate."""
    from opengl_raytracer_torch.parallel import sharding

    sent = []
    plain_send = sharding._send

    def recording_send(cols, device):
        if cols[0].device != device:
            sent.append((cols, device))
        return plain_send(cols, device)

    sharding._send = recording_send
    try:
        sr.step(state, camera)
    finally:
        sharding._send = plain_send
    n_bytes = sum(c.numel() * c.element_size() for cols, _ in sent
                  for c in cols)
    iters = 20
    _sync_all()
    t0 = time.perf_counter()
    for _ in range(iters):
        for cols, device in sent:
            for c in cols:
                c.to(device)
    _sync_all()
    ms = (time.perf_counter() - t0) * 1000.0 / iters
    say("sharded", mesh=f"{dp}x{sp}", copies_a_step=len(sent),
        routes=sorted({f"{cols[0].device}->{dev}" for cols, dev in sent}),
        mbytes=n_bytes / 1e6, copy_ms=ms,
        gbps=n_bytes / ms / 1e6 if n_bytes else None, card=repr(card))


def cards_phase(cards: int) -> None:
    """``--cards N``: phase 10's meshes over cards cuda:0 .. cuda:N-1, each
    shard on its own card (the scaling and the peer copies), held against
    the sequential render on cuda:0."""
    from opengl_raytracer_torch import make_camera

    if torch.cuda.device_count() < cards:
        raise RuntimeError(f"{cards} cards asked for, "
                           f"{torch.cuda.device_count()} present")
    camera = make_camera(CAM_POS, CAM_DIR)
    scene, _ = make_scene(83, 166, DEVICE)
    _sharded_api(scene, camera, card_line(), cards)


def _sharded_cli(straight8) -> None:
    """Phase 10's CLI runs: ``--dp 1 --sp 1`` at 1080p, 4 frames with a
    checkpoint, then 4 more resumed, against 8 straight ``App`` frames."""
    import contextlib
    import tempfile

    from opengl_raytracer_torch import __main__ as cli
    from opengl_raytracer_torch.parallel import sharding
    from opengl_raytracer_torch.utils.checkpoint import load_checkpoint
    from opengl_raytracer_torch.utils.image import load_png, rmse, to_uint8

    saved_env = os.environ.get("OGLRT_MODELS_PATH")
    Sharded = sharding.ShardedRenderer
    made = []

    class Recorded(Sharded):  # the ShardedRenderer each CLI call builds
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    with tempfile.TemporaryDirectory() as tmp:
        write_standin_objs(tmp)
        os.environ["OGLRT_MODELS_PATH"] = tmp
        sharding.ShardedRenderer = Recorded
        try:
            png, ck = os.path.join(tmp, "sharded.png"), os.path.join(tmp,
                                                                     "ck.npz")
            argv = ["--width", str(WIDTH), "--height", str(HEIGHT),
                    "--bounces", str(BOUNCES), "--frames", "4", "--dp", "1",
                    "--sp", "1", "--out", png, "--checkpoint", ck]
            for call in (1, 2):
                reset_counts()
                tee = _Tee(sys.stdout)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(tee):
                    rc = cli.main(argv)
                torch.cuda.synchronize()
                call_s = time.perf_counter() - t0
                counts = launches()
                check_probes(counts)
                r = made[-1]
                out = "".join(tee.parts)
                kind = torch.device(DEVICE).type
                if rc != 0 or f"mesh: dp=1 x sp=1 on 1 {kind} device(s)" \
                        not in out:
                    raise RuntimeError(f"sharded CLI call {call}: rc {rc}")
                if r.traversal != "pallas2" or r.home.type != kind:
                    raise RuntimeError(f"sharded CLI: {r.traversal} on "
                                       f"{r.home}")
                n, parts = r.config.n_bounces, len(r.scene.k1_parts)
                check_count(counts, "subblock_traversal", n * 4)
                check_count(counts, "shade", n * 4)
                check_count(counts, "wide_traversal", 0)
                check_glue(counts, r.traversal, n, 4, parts,
                           blocks=8 + counts["block_misses"])
                state = load_checkpoint(ck, "cpu")[0]
                if state.frame_count != 4 * call:
                    raise RuntimeError(f"sharded CLI call {call} ended at "
                                       f"frame {state.frame_count}")
                say("sharded", cli_call=call, triangles=int(r.scene.num_tris),
                    frames=f"{4 * call - 3}-{4 * call}",
                    call_s=f"{call_s:.3f}",
                    k1_launches=counts["subblock_traversal"],
                    k2_launches=counts["shade"],
                    k3_launches=counts["wide_traversal"])
            img = state.accum.numpy()
            err = rmse(img, straight8)
            if not np.isfinite(img).all() or err > 1e-7:
                raise RuntimeError(f"resumed sharded CLI image vs 8 straight "
                                   f"frames: rmse {err} (limit 1e-7)")
            decoded = np.round(load_png(png) * 255.0).astype(np.uint8)
            if not np.array_equal(decoded, to_uint8(img)):
                raise RuntimeError("the sharded CLI's PNG differs from its "
                                   "checkpoint's image")
            say("sharded", cli_resumed_vs_straight_rmse=err, limit=1e-7,
                png_round_trip="exact")
        finally:
            sharding.ShardedRenderer = Sharded
            if saved_env is None:
                os.environ.pop("OGLRT_MODELS_PATH", None)
            else:
                os.environ["OGLRT_MODELS_PATH"] = saved_env


def _sharded_small(scene, camera) -> None:
    """Phase 10's 96x54 frame of a (2, 2) mesh of the card against the
    same mesh of the CPU (the plain versions)."""
    from opengl_raytracer_torch import RenderConfig
    from opengl_raytracer_torch.parallel import ShardedRenderer, make_mesh
    from opengl_raytracer_torch.utils.image import rmse

    cfg = RenderConfig(width=SMALL[0], height=SMALL[1], bounces=BOUNCES)
    imgs = []
    for device in (DEVICE, "cpu"):
        sr = ShardedRenderer(scene, cfg, make_mesh(devices=[device] * 4,
                                                   dp=2, sp=2))
        imgs.append(sr.image(sr.render(camera, frames=2)))
    err = rmse(imgs[0], imgs[1])
    if not (np.isfinite(imgs[0]).all() and float(imgs[0].mean()) > 0.01
            and err < 1e-4):
        raise RuntimeError(f"sharded 2x2 {SMALL[0]}x{SMALL[1]}: card vs CPU "
                           f"rmse {err} (limit 1e-4), mean {imgs[0].mean()}")
    say("sharded", mesh="2x2", width=SMALL[0], height=SMALL[1],
        rmse_card_vs_cpu=err, limit=1e-4,
        max_abs=float(np.abs(imgs[0] - imgs[1]).max()))


def sharded_phase(scene, camera, straight8) -> None:
    """Multi-device rendering on one card: ``ShardedRenderer`` over meshes
    of the card repeated, through the API and through the CLI, and a
    small mesh frame on the card against the CPU."""
    card = card_line()
    _sharded_api(scene, camera, card)
    _sharded_cli(straight8)
    _sharded_small(scene, camera)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="directory for the downsampled 1080p image")
    ap.add_argument("--cards", type=int, default=1,
                    help="N > 1: only phase 10's meshes, over cards "
                         "cuda:0 .. cuda:N-1")
    args = ap.parse_args(argv)

    name = timed("device", device_phase)
    import_port()
    from opengl_raytracer_torch import make_camera

    timed("build", build_phase)
    if args.cards > 1:
        timed("sharded", cards_phase, args.cards)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    camera = make_camera(CAM_POS, CAM_DIR)
    scene, data = make_scene(83, 166, DEVICE)
    if scene.total_triangles != 31736 or len(data.k1_parts) != 1:
        raise RuntimeError("the stand-in scene changed size")
    k2 = timed("k2", k2_phase, data, args.seed, data.device)
    segments = timed("segments", frame_segments, scene, camera)
    *k1, frame_ms, sets = timed("k1", k1_phase, data, camera, segments,
                                args.seed, data.device)
    timed("k1prof", k1prof_phase, data, sets)
    packet_segments = timed("segments", frame_segments, data, camera,
                            "packet", "packet")
    glue, glue_extra = timed("glue", glue_phase, data, camera, sets,
                             args.seed, packet_segments)
    radix, radix_extra = timed("radix", radix_phase, data, camera)
    del sets, segments, packet_segments
    big_scene, big = timed("bigscene", make_scene, *BIG, DEVICE)
    if (big_scene.total_triangles != BIG_TRIANGLES
            or len(big.k1_parts) != 0):
        raise RuntimeError(f"the big scene has {big_scene.total_triangles} "
                           f"triangles and {len(big.k1_parts)} sub-block "
                           f"parts, expected {BIG_TRIANGLES} and 0")
    k3_scenes = [
        ("standin-31k", data, timed("segments", frame_segments, data, camera,
                                    "pallas", "pallas")),
        ("standin-1.96m", big, timed("segments", frame_segments, big, camera,
                                     "auto", "pallas"))]
    k3 = timed("k3", k3_phase, k3_scenes, camera, args.seed)
    timed("k3prof", k3prof_phase, k3_scenes)
    del k3_scenes
    big_counts, big_ms = timed("big", big_phase, big_scene, big, camera)
    del big_scene
    timed("graph", graph_phase,
          [("standin-31k", data, "auto", "pallas2"),
           ("standin-1.96m", big, "auto", "pallas"),
           ("standin-31k", data, "pallas", "pallas")], camera)
    cadences = [("standin-31k", data, "auto", "pallas2"),
                ("standin-31k", data, "pallas", "pallas"),
                ("standin-1.96m", big, "auto", "pallas")]
    timed("cadence", cadence_phase, cadences, camera)
    timed("k2probe", k2probe_phase, args.seed, k2[1])
    counts, main_img, main_ms = timed("main", main_path_phase, scene, camera,
                                      args.out)
    timed("display", display_phase, scene, camera)
    timed("turnaround", turnaround_phase, scene, camera)
    pallas_counts = timed("pallas", wide_path_phase, scene, camera,
                          main_img)
    counts["wide_traversal"] = pallas_counts["wide_traversal"]
    small_launches, small_ms = timed("small", small_paths_phase, scene,
                                     camera)
    counts.update(small_launches)
    packet_counts, packet_ms = timed("packet", packet_phase, scene, big,
                                     camera, main_img)
    counts["packet_walk"] = packet_counts["packet_walk"]
    timed("multipart", multipart_phase, camera)
    straight8 = timed("cli", cli_phase)
    timed("sharded", sharded_phase, scene, camera, straight8)
    timed("profile", frame_profile_phase,
          [("standin-31k", scene, main_ms, "auto"),
           ("standin-1.96m", big, big_ms, "auto"),
           ("box", demo_box(DEVICE)[0], small_ms["box", "auto"], "auto"),
           ("standin-31k", scene, small_ms["standin-31k", "bvh"], "bvh"),
           ("standin-31k", scene, packet_ms["standin-31k"], "packet")],
          camera)
    timed("cadence_profile", cadence_profile_phase, cadences, camera)

    for mod in ("jax", "opengl_raytracer_tpu"):
        if mod in sys.modules:
            raise RuntimeError(f"{mod} was imported")
    kernels = []
    for kname, (err, ms, plain_ms, (bound, by)) in (
            ("subblock_traversal", k1), ("shade", k2), ("wide_traversal", k3),
            *((g, glue[g]) for g in GLUE), ("radix_sort", radix)):
        row = dict(name=kname, route="cuda", **KERNELS[kname],
                   launches=counts[kname], max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   library_ms=None, share_of_bound=bound / ms)
        row.update(glue_extra.get(kname, {}))
        kernels.append(row)
    kernels[0]["frame_ms"] = frame_ms  # K1 over the five captured segments
    kernels[3 + GLUE.index("reorder")]["calls"] = counts["reorder"] // 2
    kernels[-1].update(radix_extra, calls=counts["radix_sort"]
                       // RADIX_LAUNCHES)
    kernels[2]["launches_big_scene_auto"] = big_counts["wide_traversal"]
    g5 = kernels[3 + GLUE.index("wide_epilogue")]
    g5["launches_pallas"] = pallas_counts["wide_epilogue"]
    g5["launches_big_scene_auto"] = big_counts["wide_epilogue"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
