"""K1 on the card: the work a ray set costs it, and a stage profile.

The H100 counterpart of the seven TPU probes of ``experiments/`` that
measured the JAX package's K1 (``ops/subblock_traversal.py``):

* ``subblock_prof.py``, ``phase_cost.py``, ``subblock_exp.py`` and
  ``subblock_bisect.py`` (the cost of one loop iteration and its split by
  stage), ``dynload_exp.py`` and ``assemble_exp.py`` (the cost of fetching
  node and octet rows): :func:`profile` launches the profile build of
  ``csrc/subblock_traversal.cu``, the same source compiled with
  ``-DOGLRT_K1_PROFILE``, whose ``clock64()`` sums give the cycles of each
  stage (group pop, node fetch, slab tests, group push, octet fetch,
  triangle tests), per visit and per fetch (:func:`stage_report`);
* ``subblock_correct.py`` (the kernel's primitives right on the hardware):
  the profile build's hits against the plain version, and
  the layout round trip of ``ops/wide2.pack_k1``/``unpack_k1``.

:func:`work` sums the per-ray counts of the plain version
(``_traverse_plain(..., counts=True)``): node visits, leaf octets, loop
steps and triangles that go on to the barycentric test, and the share of
its lanes a warp keeps busy.  ``chip_smoke.py`` turns them into
operations and K1's bound.

The profile build is a library of its own (``PROFILE_LIB``) with a launch
count of its own, ``_kernels.launch_counts["k1_profile"]``; no path of the
renderer launches it.

On a machine with a card, ``chip_smoke.py`` runs it (its ``k1prof``
phase); from Python::

    from opengl_raytracer_torch.probes import k1
    hits, stages = k1.profile(scene.k1_parts[0], o3, d3, t0)
    print(k1.stage_report(stages))
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from opengl_raytracer_torch.ops import _kernels
from opengl_raytracer_torch.ops import subblock_traversal as sbt
from opengl_raytracer_torch.ops.intersect import BIG

STAGES = ("pop", "node_fetch", "slab", "push", "octet_fetch", "triangles")
EVENTS = ("visits", "octets", "group_pushes", "group_pops", "smem_pushes",
          "smem_pops", "edge_loads")
PROFILE_LIB = os.path.join(_kernels.BUILD_DIR, "liboglrt_k1_profile.so")
SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "subblock_traversal.cu")

build_log = ""  # nvcc's output for the profile library (as _kernels')
_lock = threading.Lock()
_lib = None


def lane_share(x: torch.Tensor) -> float:
    """Mean over warps of mean(x) / max(x) in each group of 32 consecutive
    rays: the share of a warp's lanes that are busy while it runs ``x``
    steps of a loop.  Warps with no work (every ray dead) are left out."""
    n = x.numel()
    pad = -n % 32
    w = torch.cat([x.double(), x.new_zeros(pad).double()]).reshape(-1, 32)
    mx = w.max(dim=1).values
    busy = mx > 0
    if not bool(busy.any()):
        return 0.0
    # pad lanes of the last warp count as idle, as the kernel's do
    return float((w.mean(dim=1)[busy] / mx[busy]).mean())


def work(counts: torch.Tensor, t0: torch.Tensor) -> dict:
    """What one launch over these rays costs K1, from the plain version's
    (4, R) per-ray counts: visits, octets, steps and barycentric tests in
    all and per live ray, and the active-lane share of the first three."""
    R = t0.numel()
    live = int((t0 > -BIG).sum())
    visits, octets, steps, cands = (int(c.sum()) for c in counts.long())
    per = max(live, 1)
    return dict(rays=R, live=live, visits=visits, octets=octets, steps=steps,
                candidates=cands, visits_per_ray=visits / per,
                octets_per_ray=octets / per, steps_per_ray=steps / per,
                candidates_per_ray=cands / per,
                lanes_steps=lane_share(counts[2]),
                lanes_visits=lane_share(counts[0]),
                lanes_octets=lane_share(counts[1]))


def build() -> str:
    """Compile the profile build into ``PROFILE_LIB`` unless it is newer
    than the source; returns its path.  Raises when nvcc fails."""
    global build_log
    if (os.path.exists(PROFILE_LIB)
            and os.path.getmtime(PROFILE_LIB) >= os.path.getmtime(SOURCE)):
        build_log = _kernels.saved_log(PROFILE_LIB)
        return PROFILE_LIB
    build_log = _kernels.compile_library(
        PROFILE_LIB, [(SOURCE, ["-DOGLRT_K1_PROFILE"])])
    return PROFILE_LIB


def lib() -> ctypes.CDLL:
    """The profile library, built and loaded at first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build())
            so.oglrt_subblock_traverse_profile.restype = ctypes.c_int
            so.oglrt_subblock_traverse_profile.argtypes = (
                [ctypes.c_void_p] * 16 + [ctypes.c_longlong, ctypes.c_void_p])
            _lib = so
        return _lib


def profile(k1, o3, d3, t0):
    """One launch of the profile build over ``k1``, one part's (nodes,
    octets, remap) of ``SceneData.k1_parts`` -> ((t, slot, u, v), {stage
    or event name: int}).  Its hits are the part's raw ones, t = ``t0``
    where nothing beat it (the plain walk's); its cycles are summed over
    every ray's thread."""
    nodes, octets, _ = k1
    dev = t0.device
    R = t0.shape[0]
    req = _kernels.require
    for name, x in zip(("ox", "oy", "oz", "dx", "dy", "dz", "t0"),
                       (*o3, *d3, t0)):
        req(x, name, torch.float32, dev, R)
    req(nodes, "k1 nodes", torch.int32, dev)
    req(octets, "k1 octets", torch.float32, dev)
    if not t0.is_cuda:
        raise ValueError("the K1 profile runs on a CUDA card only")
    t = torch.empty(R, dtype=torch.float32, device=dev)
    slot = torch.empty(R, dtype=torch.int32, device=dev)
    u = torch.empty(R, dtype=torch.float32, device=dev)
    v = torch.empty(R, dtype=torch.float32, device=dev)
    prof = torch.zeros(len(STAGES) + len(EVENTS), dtype=torch.int64,
                       device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    overflow = sbt.overflow_tensor(dev)
    _kernels.launch(
        "oglrt_subblock_traverse_profile", "k1_profile", dev,
        *(x.data_ptr() for x in (*o3, *d3, t0, nodes, octets, t, slot, u, v,
                                 overflow, prof, sink)),
        R, library=lib())
    vals = [int(x) for x in prof.cpu()]
    return (t, slot, u, v), dict(zip(STAGES + EVENTS, vals))


def stage_report(stages: dict) -> dict:
    """Cycles of each stage in all (summed over threads), as a share of
    the stages' sum, and per event: per pop, per visit, per push, per
    octet, per 16-byte load of a fetch (15 a node; 16 an octet, the two of
    each triangle that give its t), per triangle.  The third load of a
    triangle (its edges, ``edge_loads`` of them) falls in the triangle
    stage."""
    total = sum(stages[s] for s in STAGES) or 1
    per = dict(pop=("group_pops", 1), node_fetch=("visits", 15),
               slab=("visits", 1), push=("group_pushes", 1),
               octet_fetch=("octets", 16), triangles=("octets", 8))
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

