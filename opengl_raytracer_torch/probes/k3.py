"""K3 on the card: the work a ray set costs it, a stage profile, and a
hardware check of its octet loads.

The H100 counterpart of the two TPU probes of ``experiments/`` that
measured the JAX package's K3 (``ops/pallas_traversal.py``):

* ``wide_stats.py`` (``count_kernel``: node expands against leaf
  iterations on primary rays and on sorted first-bounce rays):
  :func:`profile` launches the profile build of ``csrc/wide_traversal.cu``,
  the same source compiled with ``-DOGLRT_K3_PROFILE``, whose
  ``clock64()`` sums give the cycles of each stage (group pop, node fetch,
  slab tests, group push, octet fetch, triangle tests) and whose counts
  give visits, leaf entries, octets, triangles tested and candidate
  triangles (:func:`stage_report`); it also counts each leaf entry by its
  first octet, from which :func:`own_share` checks that K3 reads no octet
  past the entered leaf's own (an over-read, as the JAX kernel's fixed
  ``ceil(max_leaf / 8)`` octets a leaf, would read under 1);
* ``onehot_test.py`` (``kern``: one octet of the triangle tiles selected on
  the hardware and checked against the host's tile): :func:`octet_fetch`
  reads chosen octets through the kernel's own triangle loads and gives
  them back in the tiles' lane order, to be compared bit for bit with
  ``wide2.unpack_octets`` of the same rows of ``scene.k3``.

:func:`work` sums the per-ray counts of the plain version
(``_traverse_plain(..., counts=True)``): node visits, leaf entries, octets
and triangles tested, triangles that go on to the barycentric test, and
the share of its lanes a warp keeps busy.  ``chip_smoke.py`` turns them
into operations and K3's bound.

The profile build is a library of its own (``PROFILE_LIB``), with launch
counts of its own, ``_kernels.launch_counts["k3_profile"]`` and
``["k3_fetch"]``; no path of the renderer launches it.  On a machine with a
card, ``chip_smoke.py`` runs it (its ``k3prof`` phase); from Python::

    from opengl_raytracer_torch.probes import k3
    hits, stages, hist = k3.profile(scene, o3, d3, t0)
    print(k3.stage_report(stages), k3.own_share(scene, hist, stages))
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from opengl_raytracer_torch.ops import _kernels
from opengl_raytracer_torch.ops import pallas_traversal as wide
from opengl_raytracer_torch.ops.intersect import BIG
from opengl_raytracer_torch.ops.wide2 import K1_ENTRY_WORD, K1_ORDER_WORD
from opengl_raytracer_torch.ops.wide_bvh import decode_k3_leaf
from opengl_raytracer_torch.probes.k1 import lane_share

STAGES = ("pop", "node_fetch", "slab", "push", "octet_fetch", "triangles")
EVENTS = ("visits", "leaves", "octets", "candidates", "group_pushes",
          "group_pops", "smem_pushes", "smem_pops", "slots")
PROFILE_LIB = os.path.join(_kernels.BUILD_DIR, "liboglrt_k3_profile.so")
SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "wide_traversal.cu")

build_log = ""  # nvcc's output for the profile library (as _kernels')
_lock = threading.Lock()
_lib = None


def work(counts: torch.Tensor, t0: torch.Tensor) -> dict:
    """What one launch over these rays costs K3, from the plain version's
    (5, R) per-ray counts: visits, leaf entries, octets and triangles
    tested (each leaf's own), loop steps (visits and leaves) and
    barycentric tests, in all and per live ray, and the active-lane share
    of steps, visits and leaves."""
    R = t0.numel()
    live = int((t0 > -BIG).sum())
    visits, leaves, cands, octets, slots = (int(c.sum())
                                            for c in counts.long())
    steps = counts[0].long() + counts[1].long()
    per = max(live, 1)
    return dict(rays=R, live=live, visits=visits, leaves=leaves,
                octets=octets, slots=slots, steps=visits + leaves,
                candidates=cands, visits_per_ray=visits / per,
                leaves_per_ray=leaves / per, octets_per_ray=octets / per,
                slots_per_ray=slots / per,
                candidates_per_ray=cands / per,
                lanes_steps=lane_share(steps),
                lanes_visits=lane_share(counts[0]),
                lanes_leaves=lane_share(counts[1]))


def build() -> str:
    """Compile the profile build into ``PROFILE_LIB`` unless it is newer
    than the source; returns its path.  Raises when nvcc fails."""
    global build_log
    if (os.path.exists(PROFILE_LIB)
            and os.path.getmtime(PROFILE_LIB) >= os.path.getmtime(SOURCE)):
        build_log = _kernels.saved_log(PROFILE_LIB)
        return PROFILE_LIB
    build_log = _kernels.compile_library(
        PROFILE_LIB, [(SOURCE, ["-DOGLRT_K3_PROFILE"])])
    return PROFILE_LIB


def lib() -> ctypes.CDLL:
    """The profile library, built and loaded at first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build())
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            so.oglrt_wide_traverse_profile.restype = i32
            so.oglrt_wide_traverse_profile.argtypes = (
                [p] * 9 + [i32] + [p] * 8 + [i64, p])
            so.oglrt_k3_octet_fetch.restype = i32
            so.oglrt_k3_octet_fetch.argtypes = [p, p, i32, p, p]
            _lib = so
        return _lib


def profile(scene, o3, d3, t0):
    """One launch of the profile build over ``scene.k3`` -> ((t, slot, u,
    v), {stage or event name: int}, leaf entries per first octet (Q,)
    int32).  Its hits are the kernel's; its cycles are summed over every
    ray's thread."""
    nodes, octets = scene.k3
    dev = t0.device
    R = t0.shape[0]
    req = _kernels.require
    for name, x in zip(("ox", "oy", "oz", "dx", "dy", "dz", "t0"),
                       (*o3, *d3, t0)):
        req(x, name, torch.float32, dev, R)
    req(nodes, "k3 nodes", torch.int32, dev)
    req(octets, "k3 octets", torch.float32, dev)
    if not t0.is_cuda:
        raise ValueError("the K3 profile runs on a CUDA card only")
    t = torch.empty(R, dtype=torch.float32, device=dev)
    slot = torch.empty(R, dtype=torch.int32, device=dev)
    u = torch.empty(R, dtype=torch.float32, device=dev)
    v = torch.empty(R, dtype=torch.float32, device=dev)
    prof = torch.zeros(len(STAGES) + len(EVENTS), dtype=torch.int64,
                       device=dev)
    hist = torch.zeros(octets.shape[0], dtype=torch.int32, device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    overflow = wide.overflow_tensor(dev)
    _kernels.launch(
        "oglrt_wide_traverse_profile", "k3_profile", dev,
        *(x.data_ptr() for x in (*o3, *d3, t0, nodes, octets)),
        wide.group_column(scene.pw_max_stack),
        *(x.data_ptr() for x in (t, slot, u, v, overflow, prof, hist, sink)),
        R, library=lib())
    vals = [int(x) for x in prof.cpu()]
    return (t, slot, u, v), dict(zip(STAGES + EVENTS, vals)), hist


def stage_report(stages: dict) -> dict:
    """Cycles of each stage in all (summed over threads), as a share of
    the stages' sum, and per event: per pop, per visit, per push, per
    triangle tested, per 16-byte load of a fetch (15 a node; 2 a triangle,
    the two that give its t).  The third load of a triangle (its edges, one
    per candidate) falls in the triangle stage."""
    total = sum(stages[s] for s in STAGES) or 1
    per = dict(pop=("group_pops", 1), node_fetch=("visits", 15),
               slab=("visits", 1), push=("group_pushes", 1),
               octet_fetch=("slots", 2), triangles=("slots", 1))
    out = {}
    for s in STAGES:
        ev, loads = per[s]
        n = max(stages[ev], 1)
        out[s] = dict(cycles=stages[s], share=stages[s] / total,
                      per_event=stages[s] / n, event=ev)
        if loads > 1:
            out[s]["per_unit"] = stages[s] / (n * loads)
    out["events"] = {e: stages[e] for e in EVENTS}
    return out


def _leaf_octet_counts(nodes: np.ndarray, n_octets: int) -> np.ndarray:
    """Per octet q (Q,) int64 of K3's nodes (W, 64): the triangle count of
    the leaf whose entry starts at q, 0 where none starts."""
    entries = nodes[:, K1_ENTRY_WORD:K1_ORDER_WORD].astype(np.int64)
    full = (nodes[:, K1_ORDER_WORD, None].astype(np.int64)
            >> (24 + np.arange(8))) & 1
    first, n = decode_k3_leaf(entries[(full > 0) & (entries < 0)])
    out = np.zeros(n_octets, np.int64)
    out[first] = n
    return out


def own_share(scene, hist: torch.Tensor, stages: dict) -> dict:
    """What the leaf side read, from the profile's leaf entries per first
    octet and its counts of octets and triangles tested (``stages``):
    entries, octets and triangles tested in all and per entry, and the
    share of them that are the entered leaves' own (1 when no leaf reads a
    neighbour's triangles)."""
    h = hist.cpu().numpy().astype(np.int64)
    count_q = _leaf_octet_counts(scene.k3[0].cpu().numpy(), h.shape[0])
    if (h[count_q == 0] != 0).any():
        raise RuntimeError("a leaf entry starts at an octet no leaf starts at")
    entries = int(h.sum())
    octets, slots = int(stages["octets"]), int(stages["slots"])
    own_octets = int((h * -(-count_q // 8)).sum())
    own_slots = int((h * count_q).sum())
    n = max(entries, 1)
    return dict(entries=entries, octets=octets, slots=slots,
                own_octets=own_octets, own_slots=own_slots,
                own_share=own_octets / max(octets, 1),
                own_slot_share=own_slots / max(slots, 1),
                octets_per_entry=octets / n, slots_per_entry=slots / n)


def octet_fetch(scene, octets_idx) -> torch.Tensor:
    """Octets ``octets_idx`` of ``scene.k3`` read on the card by K3's own
    triangle loads -> (n, 8, 16) f32, triangle j's lanes in the order of
    the tiles: [v0, e1, e2, face, 0 0 0 0]."""
    octets = scene.k3[1]
    dev = octets.device
    if not octets.is_cuda:
        raise ValueError("the K3 octet fetch runs on a CUDA card only")
    idx = torch.as_tensor(list(octets_idx), dtype=torch.int64).to(dev)
    if idx.numel() and (int(idx.min()) < 0
                        or int(idx.max()) >= octets.shape[0]):
        raise ValueError(f"octet index out of [0, {octets.shape[0]})")
    out = torch.empty((idx.numel(), 8, 16), dtype=torch.float32, device=dev)
    _kernels.launch("oglrt_k3_octet_fetch", "k3_fetch", dev,
                    octets.data_ptr(), idx.data_ptr(), idx.numel(),
                    out.data_ptr(), library=lib())
    return out

