"""K3: nearest-hit traversal over the 8-wide BVH.

The wrapper :func:`raycast_pallas` is the port of
``opengl_raytracer_tpu/ops/pallas_traversal.py:raycast_pallas``: it runs
the traversal, resolves ``tri = pl_remap[slot]`` and masks dead rays to
``t = BIG``, the entry t and the resolution each one launch of G5
(``csrc/wide_epilogue.cu``, :func:`wide_prologue`, :func:`wide_epilogue`)
on the card.  The traversal is :func:`traverse_wide`, which picks the
version by the rays' device: on CUDA tensors it launches the kernel of
``csrc/wide_traversal.cu``, on CPU tensors it runs :func:`_traverse_plain`,
the same per-ray stack walk written with torch ops (all rays stepping
together, one stack entry popped per ray per step).  Both read the scene's
tables in the kernel's layout (``SceneData.k3``, ops/wide_bvh.pack_k3).

Both versions keep the JAX kernel's semantics (its lines cited):

* slab test with the unclamped ``inv = 1/d`` as ``(b - o) * inv``; a NaN
  from ``0 * inf`` (an axis-parallel ray whose origin lies on a slab
  plane) propagates through min and max, so that child is not opened; a
  child is opened iff ``far >= near & far >= 0 & max(near, 0) <= best_t``
  (:123-138);
* ordered children pushed far-first, each gated by the EMPTY_PACKED
  sentinel only (empty slots' swapped boxes pass the slab test; here the
  order word's mask of the non-empty slots, packed from those entries)
  (:153-176);
* within an octet the least ``t`` wins, the lowest slot among equal
  ``t``, and across octets a strict ``<`` (:216-223).  The kernel tests a
  leaf's triangles one after another with a strict ``<`` from the running
  best, which picks the same winner.

Both test exactly each leaf's own triangles: the leaf entry holds the
leaf's count (ops/wide_bvh.pack_k3).  The JAX kernel's tiles name only a
leaf's first octet, so it tests a fixed ``ceil(max_leaf / 8)`` octets from
it, over-reading into neighbouring leaves' triangles (:179-184).  That changes
no nearest hit: every triangle a ray can hit is tested in its own leaf,
whose box holds the hit point; only the slot that wins an exact ``t`` tie
can differ.

They visit the same nodes in the same order, so they agree ray by ray,
bit for bit.  The push order comes from each ray's own direction octant;
the JAX kernel uses its 1024-ray block's dominant octant (the sign of the
summed directions, :93-97), which changes only the winning slot at an
exact ``t`` tie.  The JAX kernel also opens a node for its whole block
when any ray of the block opens it (:140-146), so a ray there tests leaves
its own slab tests did not open.  That finds nothing nearer while the slab
tests are conservative; a ray whose slab test is NaN (lying in a box's
face plane) can miss here, as in the JAX package's per-ray
``raycast_bvh``, where the JAX kernel may hit.  The winner's barycentrics
come from its own test, in the formula the JAX wrapper recomputes them
with (:314-322).
"""

from __future__ import annotations

import torch

from opengl_raytracer_torch.ops import _kernels
from opengl_raytracer_torch.ops.intersect import BIG, EPS, Nearest, mt_single
from opengl_raytracer_torch.ops.wide_bvh import decode_k3_leaf, wide_depth
from opengl_raytracer_torch.ops.wide2 import (K1_ENTRY_WORD, K1_NODE_WORDS,
                                              K1_OCTET_FLOATS, K1_ORDER_WORD)

STACKS = (64, 128, 512)  # the plain version's per-ray stack sizes
# The kernel's compiled node-group columns: a tree of depth D keeps at most
# D + 1 groups open; 71 holds the deepest tree ops/wide_bvh.py accepts.
GROUPS = (16, 71)

_overflow: dict = {}  # device -> int32 (1,) running count of dropped pushes


def overflow_tensor(device) -> torch.Tensor:
    """The running count of pushes dropped on ``device`` (0 unless a stack
    smaller than the tree's bound is asked for): entry pushes in the plain
    version, node-group pushes in the kernel."""
    device = torch.device(device)
    if device not in _overflow:
        _overflow[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _overflow[device]


def stack_size(max_stack: int) -> int:
    """The smallest plain-version stack that holds ``max_stack`` entries."""
    for s in STACKS:
        if max_stack <= s:
            return s
    raise ValueError(f"wide BVH stack bound {max_stack} exceeds {STACKS[-1]}")


def group_column(max_stack: int) -> int:
    """The smallest compiled group column that holds the ``max_depth + 1``
    node groups of the wide tree whose stack bound is ``max_stack``."""
    need = wide_depth(max_stack) + 1
    for c in GROUPS:
        if need <= c:
            return c
    raise ValueError(f"wide BVH depth {need - 1} needs {need} node groups, "
                     f"more than the kernel's {GROUPS[-1]}")


def _traverse_plain(nodes, octets, o3, d3, t0, stack: int,
                    counts: bool = False):
    """Plain torch version of the kernel, over the scene's tables in the
    kernel's layout (ops/wide_bvh.pack_k3): a node's child boxes are the
    float bits of its words 0-47, its entries words 48-55 and octant o's
    near-first order word ``56 + o`` (bits 24-31, the mask of the
    non-empty slots, are masked off), taken from the far end so that the
    stack pops near-first.  A leaf entry holds the leaf's first octet and
    its triangle count (``wide_bvh.decode_k3_leaf``), and exactly those
    triangles are tested.  Returns (t, slot, u, v, dropped_pushes); t is
    ``t0`` where nothing improved it.  With ``counts``, also a (5, R)
    int32 tensor of each ray's node visits, leaf entries, triangles whose
    ``t`` beat the best hit at their test (``|det| >= EPS``, ``EPS < t <
    best_t``, the best taken in the kernel's order, slot by slot: those
    whose edges the kernel loads), octets and triangles tested."""
    dev = t0.device
    R = t0.shape[0]
    bt = t0.clone()
    slot = torch.zeros(R, dtype=torch.int32, device=dev)
    bu = torch.zeros(R, dtype=torch.float32, device=dev)
    bv = torch.zeros(R, dtype=torch.float32, device=dev)
    inv = torch.stack([1.0 / d3[a] for a in range(3)], dim=1)  # (R, 3)
    org = torch.stack(tuple(o3), dim=1)
    octant = (((d3[0] < 0.0).long() << 2) | ((d3[1] < 0.0).long() << 1)
              | (d3[2] < 0.0).long())
    n_octets = octets.shape[0]
    far_first = 3 * (7 - torch.arange(8, device=dev))  # rank i's shift
    stk = torch.zeros((R, stack), dtype=torch.int32, device=dev)
    sp = (bt > -BIG).long()  # live rays start with the root (entry 0)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    work = torch.zeros((5, R), dtype=torch.int32, device=dev)

    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        sp[act] -= 1
        ent = stk[act, sp[act]].long()
        is_node = ent >= 0

        rays = act[is_node]
        if counts:
            work[0, rays] += 1
            work[1, act[~is_node]] += 1
        if rays.numel():
            rows = nodes[ent[is_node]]
            words = rows.long()
            box = (rows[:, :48].view(torch.float32).reshape(-1, 6, 8)
                   .transpose(1, 2))  # (n, child j, 6)
            o_r, inv_r = org[rays][:, None, :], inv[rays][:, None, :]
            t1 = (box[:, :, 0:3] - o_r) * inv_r
            t2 = (box[:, :, 3:6] - o_r) * inv_r
            tmin, tmax = torch.minimum(t1, t2), torch.maximum(t1, t2)
            near = torch.maximum(torch.maximum(tmin[..., 0], tmin[..., 1]),
                                 tmin[..., 2])
            far = torch.minimum(torch.minimum(tmax[..., 0], tmax[..., 1]),
                                tmax[..., 2])
            opened = ((far >= near) & (far >= 0.0)
                      & (torch.maximum(near, torch.zeros_like(near))
                         <= bt[rays][:, None]))  # (n, child j)
            word = words.gather(1, K1_ORDER_WORD + octant[rays][:, None])
            order = ((word & 0xFFFFFF) >> far_first) & 7  # (n, rank i)
            child = words[:, K1_ENTRY_WORD:K1_ORDER_WORD].gather(1, order)
            mask = words[:, K1_ORDER_WORD, None] >> 24  # non-empty slots
            push = opened.gather(1, order) & ((mask >> order) & 1 > 0)
            for i in range(8):  # far first: rank 0 pops last
                pos = sp[rays]
                fits = push[:, i] & (pos < stack)
                dropped += (push[:, i] & ~fits).sum()
                tgt = rays[fits]
                stk[tgt, pos[fits]] = child[fits, i].to(torch.int32)
                sp[tgt] += 1

        rays = act[~is_node]
        if rays.numel():
            first, n = decode_k3_leaf(ent[~is_node])  # the leaf's own
            if counts:
                work[3, rays] += ((n + 7) >> 3).to(torch.int32)
                work[4, rays] += n.to(torch.int32)
            o_r = tuple(x[rays][:, None] for x in o3)
            d_r = tuple(x[rays][:, None] for x in d3)
            bt_r, sl_r, bu_r, bv_r = bt[rays], slot[rays], bu[rays], bv[rays]
            slots = torch.arange(8, device=dev)
            for k in range(-(-int(n.max()) // 8)):
                q = first + k
                own = slots[None, :] < (n - 8 * k)[:, None]  # (n, j)
                qc = q.clamp_max(n_octets - 1)
                # 12 x (n, j): [v0, face, e1, e2] a triangle
                c = octets[qc].reshape(-1, 8, 12).unbind(2)
                valid, t, u, v = mt_single(o_r, d_r, c[0:3], c[6:9], c[9:12],
                                           c[3:6])
                valid = valid & own
                if counts:
                    det = d_r[0] * c[3] + d_r[1] * c[4] + d_r[2] * c[5]
                    beat = own & (det.abs() >= EPS) & (t > EPS)
                    run = bt_r
                    for j in range(8):  # the kernel's running best
                        cand = beat[:, j] & (t[:, j] < run)
                        work[2, rays] += cand.to(torch.int32)
                        run = torch.where(cand & valid[:, j], t[:, j], run)
                tc = torch.where(valid, t, BIG)
                j = torch.argmin(tc, dim=1, keepdim=True)  # lowest slot on ties
                tm = tc.gather(1, j)[:, 0]
                better = tm < bt_r  # strict <, fragment.glsl:275
                bt_r = torch.where(better, tm, bt_r)
                sl_r = torch.where(better, (q * 8 + j[:, 0]).to(torch.int32),
                                   sl_r)
                bu_r = torch.where(better, u.gather(1, j)[:, 0], bu_r)
                bv_r = torch.where(better, v.gather(1, j)[:, 0], bv_r)
            bt[rays], slot[rays], bu[rays], bv[rays] = bt_r, sl_r, bu_r, bv_r
    if counts:
        return bt, slot, bu, bv, dropped, work
    return bt, slot, bu, bv, dropped


def _traverse_cuda(nodes, octets, o3, d3, t0, groups: int, overflow):
    dev = t0.device
    R = t0.shape[0]
    req = _kernels.require
    for name, x in zip(("ox", "oy", "oz", "dx", "dy", "dz", "t0"),
                       (*o3, *d3, t0)):
        req(x, name, torch.float32, dev, R)
    req(nodes, "k3 nodes", torch.int32, dev)
    req(octets, "k3 octets", torch.float32, dev)
    req(overflow, "overflow", torch.int32, dev, 1)
    if nodes.dim() != 2 or nodes.shape[1] != K1_NODE_WORDS \
            or nodes.shape[0] == 0:
        raise ValueError(f"k3 nodes must be (W, {K1_NODE_WORDS}) with W > 0, "
                         f"got {tuple(nodes.shape)}")
    if octets.dim() != 2 or octets.shape[1] != K1_OCTET_FLOATS:
        raise ValueError(f"k3 octets must be (Q, {K1_OCTET_FLOATS}), got "
                         f"{tuple(octets.shape)}")
    if nodes.data_ptr() % 16 or octets.data_ptr() % 16:
        raise ValueError("k3 tables must be 16-byte aligned (16-byte loads)")
    if groups not in GROUPS:
        raise ValueError(f"group column {groups} is not one of {GROUPS}")
    t = torch.empty(R, dtype=torch.float32, device=dev)
    slot = torch.empty(R, dtype=torch.int32, device=dev)
    u = torch.empty(R, dtype=torch.float32, device=dev)
    v = torch.empty(R, dtype=torch.float32, device=dev)
    _kernels.launch(
        "oglrt_wide_traverse", "wide_traversal", dev,
        *(x.data_ptr() for x in (*o3, *d3, t0, nodes, octets)), int(groups),
        *(x.data_ptr() for x in (t, slot, u, v, overflow)), R)
    return t, slot, u, v


def traverse_wide(scene, o3, d3, t0):
    """Nearest hit over ``scene``'s wide BVH -> (t, slot, u, v).

    ``o3``/``d3`` are 3-tuples of contiguous (R,) float32 columns and
    ``t0`` (R,) the entry best ``t`` (``-BIG`` for a dead ray, which comes
    out unchanged).  Each leaf entry tests that leaf's own triangles.
    CUDA tensors launch the kernel with the group column its depth needs,
    CPU tensors run the plain version, both over the scene's tables
    (``scene.k3``).  Dropped pushes add to
    :func:`overflow_tensor`."""
    overflow = overflow_tensor(t0.device)
    if t0.is_cuda:
        return _traverse_cuda(*scene.k3, o3, d3, t0,
                              group_column(scene.pw_max_stack), overflow)
    t, slot, u, v, dropped = _traverse_plain(
        *scene.k3, o3, d3, t0, stack_size(scene.pw_max_stack))
    overflow += dropped.to(torch.int32)
    return t, slot, u, v


def _prologue_plain(active, R: int, device):
    """Plain version of G5's prologue: K3's entry t, ``BIG`` for a live
    ray and ``-BIG`` for one that ``active`` (None: every ray live) marks
    dead."""
    t0 = torch.full((R,), BIG, dtype=torch.float32, device=device)
    return t0 if active is None else torch.where(active, t0, -BIG)


def _epilogue_plain(t, slot, u, v, remap) -> Nearest:
    """Plain version of G5's epilogue: K3's (t, slot, u, v) resolved, t =
    ``BIG``, u = v = 0 on a miss, ``tri = remap[slot]`` with the slot
    clamped into the table, as a JAX gather clamps."""
    did_hit = (t < BIG) & (t > -BIG)
    return Nearest(t=torch.where(did_hit, t, BIG),
                   tri=remap[slot.clamp(0, remap.shape[0] - 1).long()],
                   u=torch.where(did_hit, u, 0.0),
                   v=torch.where(did_hit, v, 0.0))


def _prologue_cuda(active, R: int, device):
    if active is not None:
        _kernels.require(active, "active", torch.bool, device, R)
    t0 = torch.empty(R, dtype=torch.float32, device=device)
    _kernels.launch("oglrt_wide_prologue", "wide_epilogue", device,
                    None if active is None else active.data_ptr(),
                    t0.data_ptr(), R)
    return t0


def _epilogue_cuda(t, slot, u, v, remap) -> Nearest:
    dev = t.device
    R = t.shape[0]
    req = _kernels.require
    for name, x, dtype in (("t", t, torch.float32), ("slot", slot, torch.int32),
                           ("u", u, torch.float32), ("v", v, torch.float32)):
        req(x, name, dtype, dev, R)
    req(remap, "remap", torch.int32, dev)
    if remap.dim() != 1 or remap.shape[0] == 0:
        raise ValueError(f"remap must be (N,) with N > 0, got "
                         f"{tuple(remap.shape)}")
    out = Nearest(*(torch.empty(R, dtype=dt, device=dev) for dt in (
        torch.float32, torch.int32, torch.float32, torch.float32)))
    _kernels.launch("oglrt_wide_epilogue", "wide_epilogue", dev,
                    t.data_ptr(), slot.data_ptr(), u.data_ptr(), v.data_ptr(),
                    remap.data_ptr(), remap.shape[0],
                    *(x.data_ptr() for x in out[:4]), R)
    return out


def wide_prologue(active, R: int, device):
    """K3's entry t for ``R`` rays on ``device`` (G5's first entry point):
    on a CUDA device one launch of ``csrc/wide_epilogue.cu``, else
    :func:`_prologue_plain`."""
    device = torch.device(device)
    if device.type == "cuda":
        return _prologue_cuda(active, R, device)
    return _prologue_plain(active, R, device)


def wide_epilogue(t, slot, u, v, remap) -> Nearest:
    """K3's output resolved into a :class:`Nearest` without a slot (G5's
    second entry point): on CUDA tensors one launch of
    ``csrc/wide_epilogue.cu``, else :func:`_epilogue_plain`."""
    args = (t, slot, u, v, remap)
    return _epilogue_cuda(*args) if t.is_cuda else _epilogue_plain(*args)


def raycast_pallas(scene, o3, d3, active=None) -> Nearest:
    """Nearest hit per ray over ``scene``'s wide-BVH tables.

    ``o3``/``d3`` are 3-tuples of (R,) float32 columns and ``active`` an
    optional (R,) bool mask whose False rays report ``t = BIG``.  The
    result has no slot: the shading rows are gathered by ``tri``.  The
    entry t and the resolution of K3's output are G5's two launches."""
    o3 = tuple(x.contiguous() for x in o3)
    d3 = tuple(x.contiguous() for x in d3)
    t0 = wide_prologue(active, o3[0].shape[0], o3[0].device)
    t, slot, u, v = traverse_wide(scene, o3, d3, t0)
    return wide_epilogue(t, slot, u, v, scene.pl_remap)
