"""K1: nearest-hit traversal over the sub-block BVH tables.

The wrapper :func:`raycast_subblock` is the port of
``opengl_raytracer_tpu/ops/subblock_traversal.py:raycast_subblock``: G5's
prologue (the entry t: ``BIG`` for a live ray, ``-BIG`` for a dead one),
then :func:`traverse_parts`, the scene's whole part chain.  On CUDA
tensors that is ONE launch of ``csrc/subblock_traversal.cu``'s chain
kernel a bounce segment, whatever the number of parts P (one part has a
kernel of its own, the same walk with plain arguments): each thread
walks its ray through parts 0 .. P-1 in order over the parts' Hopper
tables (``SceneData.k1_parts``, ops/wide2.pack_k1), carrying its best hit
from part to part so later parts prune against earlier hits, and resolves
the winner (miss selects, slot clamp, ``tri = remap[slot]``, the part's
slot base) itself.  On CPU tensors :func:`_chain_plain` is its plain
version: part by part, :func:`_traverse_plain` (the same per-ray stack
walk written with torch ops, all rays stepping together, one stack entry
popped per ray per step) and :func:`_resolve_plain`, combined with a
strict ``<`` so that a tie keeps the earlier part, as the kernel's carried
t does.

Both versions visit a node's children near-first in the order its node
stores for the ray's own octant, open a child iff its slab test hits with
``near <= best_t`` at the parent's visit, and update the best hit with a
strict ``<``.  They visit the same nodes in the same order, so they agree
ray by ray, bit for bit.  Against the JAX kernel, whose order follows a
packet's dominant octant, only the winning slot at an exact ``t`` tie may
differ.
"""

from __future__ import annotations

import ctypes

import torch

from opengl_raytracer_torch.ops import _kernels
from opengl_raytracer_torch.ops.intersect import BIG, EPS, Nearest, mt_single
from opengl_raytracer_torch.ops.pallas_traversal import wide_prologue
from opengl_raytracer_torch.ops.wide2 import (EMPTY_PACKED, K1_ENTRY_WORD,
                                              K1_NODE_WORDS, K1_OCTET_FLOATS,
                                              K1_ORDER_WORD)

STACK = 128  # per-ray stack entries of the plain version
MAX_PARTS = 16  # the chain kernel's table of parts (csrc: kMaxParts)
INV_CLAMP = 1e18

_overflow: dict = {}  # device -> int32 (1,) running count of dropped pushes


def overflow_tensor(device) -> torch.Tensor:
    """The running count of stack pushes dropped on ``device`` (0 unless a
    scene's tree is deeper than ops/wide2.py allows): child pushes in the
    plain version, node-group pushes in the kernel."""
    device = torch.device(device)
    if device not in _overflow:
        _overflow[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _overflow[device]


def _traverse_plain(nodes, octets, o3, d3, t0, counts: bool = False):
    """Plain torch version of the kernel, over the part's tables in the
    kernel's layout (ops/wide2.pack_k1): a node's child boxes are the
    float bits of its words 0-47, its entries words 48-55 and octant o's
    near-first order word ``56 + o``, taken from the far end so that the
    stack pops near-first.  Returns (t, slot, u, v, dropped_pushes) for one
    part; t is ``t0`` where nothing improved it.

    With ``counts``, also a (4, R) int32 tensor of each ray's node visits,
    leaf octets tested, loop steps (stack pops: visits + octets) and
    triangles whose ``t`` beat the best hit (``|det| >= EPS``, ``EPS < t <
    best_t``: those the kernel goes on to test for barycentrics), the work
    the kernel does for the same ray."""
    dev = t0.device
    R = t0.shape[0]
    bt = t0.clone()
    slot = torch.zeros(R, dtype=torch.int32, device=dev)
    bu = torch.zeros(R, dtype=torch.float32, device=dev)
    bv = torch.zeros(R, dtype=torch.float32, device=dev)
    inv = [(1.0 / d3[a]).clamp(-INV_CLAMP, INV_CLAMP) for a in range(3)]
    oi = [o3[a] * inv[a] for a in range(3)]
    octant = (((d3[0] < 0.0).long() << 2) | ((d3[1] < 0.0).long() << 1)
              | (d3[2] < 0.0).long())
    ord_word = K1_ORDER_WORD + octant
    stack = torch.zeros((R, STACK), dtype=torch.int32, device=dev)
    sp = (bt > -BIG).long()  # live rays start with the root (entry 0)
    axes6 = torch.arange(6, device=dev) * 8  # lo.xyz, hi.xyz of slot 0
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    work = torch.zeros((4, R), dtype=torch.int32, device=dev)

    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        sp[act] -= 1
        ent = stack[act, sp[act]].long()
        is_node = ent >= 0

        rays = act[is_node]
        if counts:
            work[0, rays] += 1
            work[1, act[~is_node]] += 1
        if rays.numel():
            words = nodes[ent[is_node]]
            box_w = words.view(torch.float32)
            inv_r = [x[rays] for x in inv]
            oi_r = [x[rays] for x in oi]
            bt_r = bt[rays]
            order = words.gather(1, ord_word[rays][:, None]).long()
            for k in range(8):  # far first: near-first rank 7 - k
                s = (order >> (3 * (7 - k))) & 7
                child = words.gather(1, K1_ENTRY_WORD + s)[:, 0].long()
                b = box_w.gather(1, s + axes6)
                t1 = [b[:, a] * inv_r[a] - oi_r[a] for a in range(3)]
                t2 = [b[:, 3 + a] * inv_r[a] - oi_r[a] for a in range(3)]
                near = torch.maximum(
                    torch.maximum(torch.minimum(t1[0], t2[0]),
                                  torch.minimum(t1[1], t2[1])),
                    torch.minimum(t1[2], t2[2]))
                far = torch.minimum(
                    torch.minimum(torch.maximum(t1[0], t2[0]),
                                  torch.maximum(t1[1], t2[1])),
                    torch.maximum(t1[2], t2[2]))
                ok = ((far >= near) & (far >= 0.0) & (near <= bt_r)
                      & (child != EMPTY_PACKED))
                pos = sp[rays]
                fits = ok & (pos < STACK)
                dropped += (ok & ~fits).sum()
                tgt = rays[fits]
                stack[tgt, pos[fits]] = child[fits].to(torch.int32)
                sp[tgt] += 1

        rays = act[~is_node]
        if rays.numel():
            q = -ent[~is_node] - 1
            rows = octets[q]
            o_r = [x[rays] for x in o3]
            d_r = [x[rays] for x in d3]
            bt_r, sl_r, bu_r, bv_r = bt[rays], slot[rays], bu[rays], bv[rays]
            for j in range(8):  # [v0, face, e1, e2] a triangle
                c = rows[:, j * 12:j * 12 + 12].unbind(1)
                valid, t, u, v = mt_single(o_r, d_r, c[0:3], c[6:9], c[9:12],
                                           c[3:6])
                if counts:
                    det = d_r[0] * c[3] + d_r[1] * c[4] + d_r[2] * c[5]
                    work[3, rays] += ((det.abs() >= EPS) & (t > EPS)
                                      & (t < bt_r)).to(torch.int32)
                better = valid & (t < bt_r)  # strict <, fragment.glsl:275
                bt_r = torch.where(better, t, bt_r)
                sl_r = torch.where(better, (q * 8 + j).to(torch.int32), sl_r)
                bu_r = torch.where(better, u, bu_r)
                bv_r = torch.where(better, v, bv_r)
            bt[rays], slot[rays], bu[rays], bv[rays] = bt_r, sl_r, bu_r, bv_r
    if counts:
        work[2] = work[0] + work[1]
        return bt, slot, bu, bv, dropped, work
    return bt, slot, bu, bv, dropped


def _check_tables(nodes, octets, dev) -> None:
    req = _kernels.require
    req(nodes, "k1 nodes", torch.int32, dev)
    req(octets, "k1 octets", torch.float32, dev)
    if nodes.dim() != 2 or nodes.shape[1] != K1_NODE_WORDS \
            or nodes.shape[0] == 0:
        raise ValueError(f"k1 nodes must be (W, {K1_NODE_WORDS}) with W > 0, "
                         f"got {tuple(nodes.shape)}")
    if octets.dim() != 2 or octets.shape[1] != K1_OCTET_FLOATS:
        raise ValueError(f"k1 octets must be (Q, {K1_OCTET_FLOATS}), got "
                         f"{tuple(octets.shape)}")
    if nodes.data_ptr() % 16 or octets.data_ptr() % 16:
        raise ValueError("k1 tables must be 16-byte aligned (16-byte loads)")


def _check_rays(o3, d3, t0, overflow) -> None:
    dev = t0.device
    R = t0.shape[0]
    for name, x in zip(("ox", "oy", "oz", "dx", "dy", "dz", "t0"),
                       (*o3, *d3, t0)):
        _kernels.require(x, name, torch.float32, dev, R)
    _kernels.require(overflow, "overflow", torch.int32, dev, 1)


def _resolve_plain(t, slot, u, v, remap, slot_base: int, near) -> Nearest:
    """One part's hits (t, slot, u, v) resolved, as the chain kernel
    resolves its winner (a miss selects t = ``BIG``, u = v = 0; the slot
    clamped into ``remap``; ``tri = remap[slot]``; the part's slot base),
    and combined with the earlier parts' ``near`` (None for the first
    part) by a strict ``<``: ties keep the earlier part."""
    did_hit = (t < BIG) & (t > -BIG)
    slot = slot.clamp(0, remap.shape[0] - 1)
    pn = Nearest(
        t=torch.where(did_hit, t, BIG),
        tri=remap[slot.long()],
        u=torch.where(did_hit, u, 0.0),
        v=torch.where(did_hit, v, 0.0),
        slot=slot + slot_base,
    )
    if near is None:
        return pn
    better = pn.t < near.t  # strict <: ties keep the earlier part
    return Nearest(*(torch.where(better, a, b) for a, b in zip(pn, near)))


def _chain_plain(parts, o3, d3, t0, counts: bool = False):
    """Plain version of the chain kernel over ``parts`` (the scene's
    ``k1_parts``): each part walked in order from the best t so far (a
    dead ray, ``t0 = -BIG``, stays dead), its hits resolved and combined.
    Returns (near, dropped pushes); with ``counts``, also the (4, R) work
    of :func:`_traverse_plain` summed over the parts."""
    near, slot_base, entry = None, 0, t0
    dropped = torch.zeros((), dtype=torch.int64, device=t0.device)
    work = 0
    for nodes, octets, remap in parts:
        if counts:
            t, slot, u, v, d, w = _traverse_plain(nodes, octets, o3, d3,
                                                  entry, counts=True)
            work = work + w
        else:
            t, slot, u, v, d = _traverse_plain(nodes, octets, o3, d3, entry)
        near = _resolve_plain(t, slot, u, v, remap, slot_base, near)
        dropped += d
        slot_base += int(remap.shape[0])
        entry = torch.where(t0 > -BIG, near.t, t0)
    return (near, dropped, work) if counts else (near, dropped)


def _chain_cuda(parts, o3, d3, t0, overflow) -> Nearest:
    dev = t0.device
    R = t0.shape[0]
    _check_rays(o3, d3, t0, overflow)
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"the chain kernel takes 1 to {MAX_PARTS} parts, "
                         f"got {len(parts)}")
    table, slot_base = [], 0
    for nodes, octets, remap in parts:
        _check_tables(nodes, octets, dev)
        _kernels.require(remap, "remap", torch.int32, dev)
        if remap.dim() != 1 or remap.shape[0] == 0:
            raise ValueError(f"remap must be (N,) with N > 0, got "
                             f"{tuple(remap.shape)}")
        table += [nodes.data_ptr(), octets.data_ptr(), remap.data_ptr(),
                  remap.shape[0], slot_base]
        slot_base += int(remap.shape[0])
    if slot_base >= 2**31:
        raise ValueError(f"{slot_base} slots overflow the kernel's int32")
    words = (ctypes.c_longlong * len(table))(*table)
    out = Nearest(*(torch.empty(R, dtype=dt, device=dev) for dt in (
        torch.float32, torch.int32, torch.float32, torch.float32,
        torch.int32)))
    _kernels.launch("oglrt_subblock_traverse_parts", "subblock_traversal",
                    dev, *(x.data_ptr() for x in (*o3, *d3, t0)),
                    ctypes.addressof(words), len(parts),
                    *(x.data_ptr() for x in (*out, overflow)), R)
    _kernels.launch_counts["subblock_parts"] += len(parts)
    return out


def traverse_parts(scene, o3, d3, t0) -> Nearest:
    """Nearest hit over every sub-block part of ``scene``, resolved.

    ``o3``/``d3`` are 3-tuples of contiguous (R,) float32 columns and
    ``t0`` (R,) the entry best ``t`` (at most ``BIG``; ``-BIG`` for a dead
    ray, which comes out as a miss).  CUDA tensors launch the chain kernel
    once, CPU tensors run :func:`_chain_plain`.  Dropped stack pushes add
    to :func:`overflow_tensor`."""
    overflow = overflow_tensor(t0.device)
    if t0.is_cuda:
        return _chain_cuda(scene.k1_parts, o3, d3, t0, overflow)
    near, dropped = _chain_plain(scene.k1_parts, o3, d3, t0)
    overflow += dropped.to(torch.int32)
    return near


def raycast_subblock(scene, o3, d3, active=None):
    """Nearest hit per ray over every sub-block part of ``scene``.

    ``o3``/``d3`` are 3-tuples of (R,) float32 columns; ``active`` an
    optional (R,) bool mask whose False rays report ``t = BIG``.  The
    entry t is K3's (G5's prologue, one launch on the card); the chain is
    :func:`traverse_parts` (one launch on the card)."""
    if not scene.k1_parts:
        raise ValueError("scene has no sub-block tables (exceeded caps?)")
    o3 = tuple(x.contiguous() for x in o3)
    d3 = tuple(x.contiguous() for x in d3)
    t0 = wide_prologue(active, o3[0].shape[0], o3[0].device)  # G5's
    return traverse_parts(scene, o3, d3, t0)
