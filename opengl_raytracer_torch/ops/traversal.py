"""The binary BVH's two walks: per ray and per 128-ray packet.

:func:`raycast_bvh` is the port of
``opengl_raytracer_tpu/ops/traversal.py:raycast_bvh``: every ray carries
one node index through the DFS-preorder-with-miss-links layout
(ops/bvh.py).  A node whose box the ray enters no farther than its
current nearest hit is opened: a leaf's triangles are tested and the walk
goes on to the node's miss link, an internal node steps to its first
child.  A missed node jumps to its miss link.  The JAX version is XLA
code outside any kernel.  On CUDA rays the walk is one launch of
``csrc/bvh_walk.cu`` (G7), one thread walking one ray to its end over the
scene's node and triangle records (``SceneData.node_records``,
:func:`pack_node_records`; ``SceneData.tri_records``), so a tile step's
CUDA graph holds it; on CPU rays it runs :func:`_walk_plain` over the same
records, one step per loop iteration over the rays still walking, with
one host check per step.  The two agree bit for bit on the card.

:func:`raycast_packet` is the port of
``opengl_raytracer_tpu/ops/traversal.py:raycast_packet``, the ``"packet"``
traversal: rays ``128 p .. 128 p + 127`` form packet ``p`` (the renderer
orders them into 8x16 pixel blocks) and share ONE node pointer; a node is
opened when any live ray of the packet enters it ahead of its own nearest
hit, an opened leaf is tested by every ray of the packet, and each ray
accepts only hits nearer than its own.  On CUDA rays it is one launch of
``csrc/packet_walk.cu`` (G9), a 128-thread block a packet, over the same
records as G7, each opened leaf staged in shared memory; on CPU rays it
runs :func:`_packet_plain`, one step of every packet still walking per
loop iteration.  The two agree bit for bit on the card.  A ray's
nearest t is the per-ray walk's wherever its own slab tests are
conservative (the winning triangle may differ at an exact-t tie); a ray
in a box's face plane, whose slab test is NaN, opens nothing itself but
tests the leaves its packet opens, so it may hit where the per-ray walk
misses, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opengl_raytracer_torch.ops import _kernels
from opengl_raytracer_torch.ops.intersect import (BIG, EPS, Nearest, _dot3,
                                                  init_nearest, mt_single,
                                                  slab_test,
                                                  unpack_tri_records)


PACKET = 128  # rays a packet, as the JAX package's


def _walk_plain(scene, o3, d3, active=None, max_leaf_tris: int = 4,
                counts: bool = False):
    """Plain torch version of the walk kernel, over the columns of the
    scene's node and triangle records.  With ``counts``, also a
    (3, R) int32 tensor of each ray's loop steps (node visits), triangle
    tests, and candidates (tests with ``|det| >= EPS`` and ``EPS < t <``
    the nearest hit, whose u and v the kernel computes): the work the
    kernel does for a live ray."""
    origin = torch.stack(tuple(o3), dim=1)
    direction = torch.stack(tuple(d3), dim=1)
    R = origin.shape[0]
    node_min, node_max, node_miss, node_first, node_count = \
        unpack_node_records(scene.node_records)
    v0, e1, e2, face3 = unpack_tri_records(scene.tri_records)
    N = node_miss.shape[0]
    inv_dir = 1.0 / direction
    t, tri, u, v, _ = init_nearest(R, origin.device)
    if active is not None:
        t = torch.where(active, t, -BIG)  # dead rays open no node
    node = torch.zeros(R, dtype=torch.int64, device=origin.device)
    work = torch.zeros((3, R), dtype=torch.int32, device=origin.device)

    while True:
        rays = torch.nonzero(node < N).squeeze(1)
        if rays.numel() == 0:
            break
        nidx = node[rays]
        if counts:
            work[0, rays] += 1
        o, d, bt = origin[rays], direction[rays], t[rays]
        t_near = slab_test(o, inv_dir[rays], node_min[nidx],
                           node_max[nidx])
        # Visit iff the box is entered ahead of the nearest hit
        # (fragment.glsl:261-262).
        box_hit = (t_near >= 0.0) & (t_near <= bt)
        count = node_count[nidx]
        is_leaf = count > 0

        leaf = torch.nonzero(box_hit & is_leaf).squeeze(1)
        if leaf.numel():
            lr = rays[leaf]
            if counts:
                work[1, lr] += count[leaf].clamp_max(max_leaf_tris)
            o_l = o[leaf].unbind(1)
            d_l = d[leaf].unbind(1)
            first, cnt = node_first[nidx[leaf]], count[leaf]
            bt_l, tri_l, u_l, v_l = bt[leaf], tri[lr], u[lr], v[lr]
            for k in range(max_leaf_tris):
                ok = k < cnt
                idx = torch.where(ok, first + k, 0).long()
                face = face3[idx].unbind(1)
                valid, tk, uk, vk = mt_single(
                    o_l, d_l, v0[idx].unbind(1), e1[idx].unbind(1),
                    e2[idx].unbind(1), face)
                if counts:
                    work[2, lr] += (ok & (_dot3(d_l, face).abs() >= EPS)
                                    & (tk > EPS) & (tk < bt_l)).int()
                upd = ok & valid & (tk < bt_l)  # strict <, fragment.glsl:275
                bt_l = torch.where(upd, tk, bt_l)
                tri_l = torch.where(upd, idx.to(torch.int32), tri_l)
                u_l = torch.where(upd, uk, u_l)
                v_l = torch.where(upd, vk, v_l)
            t[lr], tri[lr], u[lr], v[lr] = bt_l, tri_l, u_l, v_l

        node[rays] = torch.where(box_hit & ~is_leaf, nidx + 1,
                                 node_miss[nidx].long())
    if active is not None:
        t = torch.where(active, t, BIG)
    near = Nearest(t=t, tri=tri, u=u, v=v)
    return (near, work) if counts else near


# A node record's last word packs first + 1 (a first of -1 fits) in its
# low 21 bits and count in its high 11, as csrc/bvh_walk.cu decodes it; a
# scene whose values do not fit gets 48-byte records with both words whole.
_FIRST_BITS = 21
_COUNT_BITS = 11


def pack_node_records(node_min, node_max, node_miss, node_first,
                      node_count) -> torch.Tensor:
    """The binary BVH as the node records G7 and G9 read, packed at upload
    (``SceneData.node_records``), int32 words (floats by their bits):
    (N, 8), 32 bytes a node, ``min.xyz, miss, max.xyz,
    (first + 1) | count << 21``, or (N, 12), 48 bytes, ``min.xyz, miss,
    max.xyz, first, count, 0, 0, 0`` when a first or a count does not fit
    its bits.  Read with 16-byte loads; :func:`unpack_node_records` is the
    inverse."""
    lo = node_min.contiguous().view(torch.int32)
    hi = node_max.contiguous().view(torch.int32)
    miss = node_miss[:, None]
    first1 = node_first.long() + 1
    count = node_count.long()
    fits = node_miss.numel() == 0 or bool(
        (first1.min() >= 0) & (first1.max() < 1 << _FIRST_BITS)
        & (count.min() >= 0) & (count.max() < 1 << _COUNT_BITS))
    if fits:
        word = first1 | (count << _FIRST_BITS)
        word = torch.where(word >= 1 << 31, word - (1 << 32), word)
        tail = (word.to(torch.int32)[:, None],)
    else:
        tail = (node_first[:, None], node_count[:, None],
                node_count.new_zeros((node_count.shape[0], 3)))
    return torch.cat((lo, miss, hi, *tail), dim=1).contiguous()


def unpack_node_records(rec: torch.Tensor) -> tuple:
    """(node_min, node_max, node_miss, node_first, node_count) from
    :func:`pack_node_records`'s records, bit for bit."""
    node_min = rec[:, 0:3].contiguous().view(torch.float32)
    node_max = rec[:, 4:7].contiguous().view(torch.float32)
    miss = rec[:, 3].contiguous()
    if rec.shape[1] == 12:
        return node_min, node_max, miss, rec[:, 7].contiguous(), \
            rec[:, 8].contiguous()
    word = rec[:, 7].long() & 0xFFFFFFFF
    first = ((word & ((1 << _FIRST_BITS) - 1)) - 1).to(torch.int32)
    return node_min, node_max, miss, first, \
        (word >> _FIRST_BITS).to(torch.int32)


def _launch_walk(symbol: str, counter: str, scene, o3, d3, active,
                 max_leaf_tris: int) -> Nearest:
    """One launch of a walk kernel over ``scene``'s node and triangle
    records: G7 or G9, which take the same arguments."""
    dev = o3[0].device
    R = o3[0].shape[0]
    req = _kernels.require
    for name, x in zip(("ox", "oy", "oz", "dx", "dy", "dz"), (*o3, *d3)):
        req(x, name, torch.float32, dev, R)
    if active is not None:
        req(active, "active", torch.bool, dev, R)
    nodes, tris = scene.node_records, scene.tri_records
    N = nodes.shape[0]
    if nodes.shape[1] not in (8, 12):
        raise ValueError(f"node records of {nodes.shape[1]} words")
    req(nodes, "node records", torch.int32, dev, N * nodes.shape[1])
    req(tris, "triangle records", torch.float32, dev, scene.num_tris * 12)
    out = Nearest(*(torch.empty(R, dtype=dt, device=dev) for dt in (
        torch.float32, torch.int32, torch.float32, torch.float32)))
    _kernels.launch(
        symbol, counter, dev, *(x.data_ptr() for x in (*o3, *d3)),
        None if active is None else active.data_ptr(), nodes.data_ptr(),
        int(nodes.shape[1] == 12), N, tris.data_ptr(), int(max_leaf_tris),
        *(x.data_ptr() for x in out[:4]), R)
    return out


def _walk_cuda(scene, o3, d3, active=None, max_leaf_tris: int = 4):
    return _launch_walk("oglrt_bvh_walk", "bvh_walk", scene, o3, d3, active,
                        max_leaf_tris)


def _packet_cuda(scene, o3, d3, active=None, max_leaf_tris: int = 4):
    return _launch_walk("oglrt_packet_walk", "packet_walk", scene, o3, d3,
                        active, max_leaf_tris)


def raycast_bvh(scene, o3, d3, active=None, max_leaf_tris: int = 4) -> Nearest:
    """Nearest hit per ray by the stackless walk.  ``o3``/``d3`` are
    3-tuples of (R,) columns, ``active`` an optional (R,) bool mask whose
    False rays report ``t = BIG``; ``max_leaf_tris`` must cover the
    scene's largest leaf.  CUDA rays: one launch of ``csrc/bvh_walk.cu``
    (G7); CPU rays: :func:`_walk_plain`."""
    o3 = tuple(x.contiguous() for x in o3)
    d3 = tuple(x.contiguous() for x in d3)
    args = (scene, o3, d3, active, max_leaf_tris)
    return _walk_cuda(*args) if o3[0].is_cuda else _walk_plain(*args)


class PacketWork(NamedTuple):
    """What :func:`_packet_plain` counts: the work G9 does."""

    visits: torch.Tensor  # (P,) int32: nodes a packet loads and tests
    slots: torch.Tensor  # (P,) int32: leaf triangles a packet tests
    candidates: torch.Tensor  # (R,) int32: a ray's tests whose t would win


def _packet_plain(scene, o3, d3, active=None, max_leaf_tris: int = 4,
                  counts: bool = False):
    """Plain torch version of the packet walk kernel: the JAX package's
    ``raycast_packet`` loop over (P, 128) tensors, one step of every packet
    still walking per loop iteration (a packet steps on its own, so the
    JAX package's two phases, every packet to a leaf and then every
    pending leaf, give each packet the same steps).  At a packet's node,
    each ray's slab test against its own nearest hit; the node is opened
    when any ray enters it: a leaf's first ``min(count, max_leaf_tris)``
    triangles are tested by every ray of the packet with a strict ``<``
    and the packet goes to the miss link, an inner node to ``node + 1``;
    a node no ray enters, to its miss link.  Dead rays start at ``t =
    -BIG`` (they open and accept nothing) and report ``t = BIG``; a packet
    with no live ray starts done.  With ``counts``, also a
    :class:`PacketWork`."""
    origin = torch.stack(tuple(o3), dim=1)
    direction = torch.stack(tuple(d3), dim=1)
    R = origin.shape[0]
    P = R // PACKET  # R a multiple of PACKET (raycast_packet checks)
    node_min, node_max, node_miss, node_first, node_count = \
        unpack_node_records(scene.node_records)
    tri_cols = unpack_tri_records(scene.tri_records)
    N = node_miss.shape[0]
    dev = origin.device
    o = origin.view(P, PACKET, 3)
    d = direction.view(P, PACKET, 3)
    inv = (1.0 / direction).view(P, PACKET, 3)
    t, tri, u, v, _ = (None if x is None else x.view(P, PACKET)
                       for x in init_nearest(R, dev))
    node = torch.zeros(P, dtype=torch.int64, device=dev)
    if active is not None:
        live = active.view(P, PACKET)
        t = torch.where(live, t, -BIG)  # dead rays open no node
        node = torch.where(live.any(dim=1), node, N)
    visits = torch.zeros(P, dtype=torch.int32, device=dev)
    slots = torch.zeros(P, dtype=torch.int32, device=dev)
    cands = torch.zeros((P, PACKET), dtype=torch.int32, device=dev)

    while True:
        pk = torch.nonzero(node < N).squeeze(1)
        if pk.numel() == 0:
            break
        nidx = node[pk]
        if counts:
            visits[pk] += 1
        t_near = slab_test(o[pk], inv[pk], node_min[nidx][:, None],
                           node_max[nidx][:, None])
        opened = ((t_near >= 0.0) & (t_near <= t[pk])).any(dim=1)
        count = node_count[nidx]
        is_leaf = count > 0

        leaf = torch.nonzero(opened & is_leaf).squeeze(1)
        if leaf.numel():
            lp = pk[leaf]
            m = count[leaf].clamp_max(max_leaf_tris)
            if counts:
                slots[lp] += m
            # the leaf's slots k < m at once, (L, M, 128); the kernel's
            # strict < one after another keeps the least t, the first
            # slot among equal t: argmin's first index
            ks = torch.arange(int(m.max()), device=dev)
            ok = (ks < m[:, None])[..., None]
            first = node_first[nidx[leaf]][:, None]
            idx = torch.where(ok[..., 0], first + ks, 0).long()
            tri_t = [tuple(x[..., None] for x in tab[idx].unbind(2))
                     for tab in tri_cols]
            o_l = tuple(x[:, None] for x in o[lp].unbind(2))
            d_l = tuple(x[:, None] for x in d[lp].unbind(2))
            valid, tk, uk, vk = mt_single(o_l, d_l, *tri_t)
            bt = t[lp]
            ts = torch.where(ok & valid, tk, float("inf"))
            if counts:
                # the nearest hit before each slot
                before = torch.cat((bt[:, None], ts[:, :-1]), 1).cummin(1)[0]
                cands[lp] += (ok & (_dot3(d_l, tri_t[3]).abs() >= EPS)
                              & (tk > EPS) & (tk < before)).sum(1).int()
            best, arg = ts.min(1)
            upd = best < bt  # strict <, fragment.glsl:275
            t[lp] = torch.where(upd, best, bt)
            tri[lp] = torch.where(upd, idx.gather(1, arg).to(torch.int32),
                                  tri[lp])
            u[lp] = torch.where(upd, uk.gather(1, arg[:, None])[:, 0], u[lp])
            v[lp] = torch.where(upd, vk.gather(1, arg[:, None])[:, 0], v[lp])

        node[pk] = torch.where(opened & ~is_leaf, nidx + 1,
                               node_miss[nidx].long())
    t = t.reshape(R)
    if active is not None:
        t = torch.where(active, t, BIG)
    near = Nearest(t=t, tri=tri.reshape(R), u=u.reshape(R), v=v.reshape(R))
    if not counts:
        return near
    return near, PacketWork(visits, slots, cands.reshape(R))


def raycast_packet(scene, o3, d3, active=None,
                   max_leaf_tris: int = 4) -> Nearest:
    """Nearest hit per ray by the packet walk.  ``o3``/``d3`` are 3-tuples
    of (R,) columns, R a multiple of 128 (the renderer's chunks are whole
    packets), ``active`` an optional (R,) bool mask whose False rays report
    ``t = BIG``; ``max_leaf_tris`` must cover the scene's largest leaf.
    CUDA rays: one launch of ``csrc/packet_walk.cu`` (G9); CPU rays:
    :func:`_packet_plain`."""
    o3 = tuple(x.contiguous() for x in o3)
    d3 = tuple(x.contiguous() for x in d3)
    if o3[0].shape[0] % PACKET:
        raise ValueError(f"ray count {o3[0].shape[0]} not a multiple of "
                         f"packet {PACKET}")
    args = (scene, o3, d3, active, max_leaf_tris)
    return _packet_cuda(*args) if o3[0].is_cuda else _packet_plain(*args)
