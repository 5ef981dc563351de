"""Per-ray stackless BVH traversal over the binary BVH.

:func:`raycast_bvh` is the port of
``opengl_raytracer_tpu/ops/traversal.py:raycast_bvh``: every ray carries
one node index through the DFS-preorder-with-miss-links layout
(ops/bvh.py).  A node whose box the ray enters no farther than its
current nearest hit is opened: a leaf's triangles are tested and the walk
goes on to the node's miss link, an internal node steps to its first
child.  A missed node jumps to its miss link.  It is plain torch, as the
JAX version is XLA code outside any kernel: one step per loop iteration
over the rays still walking, with one host check per step.

The JAX package's packet traversal (``raycast_packet``) is not ported: its
``[P, 128]`` shared node pointer answers XLA on the TPU.  The renderer
routes the name ``"packet"`` to the wide-BVH kernel (K3) instead.
"""

from __future__ import annotations

import torch

from opengl_raytracer_torch.ops.intersect import (BIG, Nearest, init_nearest,
                                                  mt_single, slab_test)


def raycast_bvh(scene, o3, d3, active=None, max_leaf_tris: int = 4) -> Nearest:
    """Nearest hit per ray by the stackless walk.  ``o3``/``d3`` are
    3-tuples of (R,) columns, ``active`` an optional (R,) bool mask whose
    False rays report ``t = BIG``; ``max_leaf_tris`` must cover the
    scene's largest leaf."""
    origin = torch.stack(tuple(o3), dim=1)
    direction = torch.stack(tuple(d3), dim=1)
    R = origin.shape[0]
    N = scene.node_miss.shape[0]
    inv_dir = 1.0 / direction
    t, tri, u, v, _ = init_nearest(R, origin.device)
    if active is not None:
        t = torch.where(active, t, -BIG)  # dead rays open no node
    node = torch.zeros(R, dtype=torch.int64, device=origin.device)

    while True:
        rays = torch.nonzero(node < N).squeeze(1)
        if rays.numel() == 0:
            break
        nidx = node[rays]
        o, d, bt = origin[rays], direction[rays], t[rays]
        t_near = slab_test(o, inv_dir[rays], scene.node_min[nidx],
                           scene.node_max[nidx])
        # Visit iff the box is entered ahead of the nearest hit
        # (fragment.glsl:261-262).
        box_hit = (t_near >= 0.0) & (t_near <= bt)
        count = scene.node_count[nidx]
        is_leaf = count > 0

        leaf = torch.nonzero(box_hit & is_leaf).squeeze(1)
        if leaf.numel():
            lr = rays[leaf]
            o_l = o[leaf].unbind(1)
            d_l = d[leaf].unbind(1)
            first, cnt = scene.node_first[nidx[leaf]], count[leaf]
            bt_l, tri_l, u_l, v_l = bt[leaf], tri[lr], u[lr], v[lr]
            for k in range(max_leaf_tris):
                ok = k < cnt
                idx = torch.where(ok, first + k, 0).long()
                valid, tk, uk, vk = mt_single(
                    o_l, d_l, scene.v0[idx].unbind(1), scene.e1[idx].unbind(1),
                    scene.e2[idx].unbind(1), scene.face[idx].unbind(1))
                upd = ok & valid & (tk < bt_l)  # strict <, fragment.glsl:275
                bt_l = torch.where(upd, tk, bt_l)
                tri_l = torch.where(upd, idx.to(torch.int32), tri_l)
                u_l = torch.where(upd, uk, u_l)
                v_l = torch.where(upd, vk, v_l)
            t[lr], tri[lr], u[lr], v[lr] = bt_l, tri_l, u_l, v_l

        node[rays] = torch.where(box_hit & ~is_leaf, nidx + 1,
                                 scene.node_miss[nidx].long())
    if active is not None:
        t = torch.where(active, t, BIG)
    return Nearest(t=t, tri=tri, u=u, v=v)
