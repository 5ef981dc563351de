"""Sub-block traversal tables: 8-wide BVH in a ROW layout + octet leaves.

A NumPy copy of ``opengl_raytracer_tpu/ops/wide2.py``'s builder, so that
this package and the JAX package traverse bit-identical tables and their
nearest hits can be compared ray by ray.  The layout was shaped for the
TPU kernel (one dynamically loadable 128-float row per node and per leaf
octet).  Here it is the builder's output, what the tests hold against the
JAX package, and the packer's input; no device holds it:

* ``node_rows (Wp, 128) f32`` — wide node w = row w:
  - lanes ``[j*6, j*6+6)``: child j's [bmin.xyz, bmax.xyz]; empty slots
    hold swapped finite bounds (+BIG/-BIG; they'd pass a canonicalizing
    slab test, but the kernel tests min/max in slot form so they miss —
    and the EMPTY sentinel gates the push regardless)
  - lanes ``[ORD0 + o*8 + i]``: per-octant far-first push entries packed
    as exact-integer floats ``entry*8 + slot`` (rank i pops later ranks
    first: a LIFO stack makes far-first pushes near-first pops)
* ``tri_rows (Qp, 128) f32`` — leaf octet q = row q: triangle j at lanes
  ``[j*16, j*16+12)`` as [v0.xyz, e1.xyz, e2.xyz, face.xyz]; every leaf
  is EXACTLY ONE octet (the binary build uses max 8 tris/leaf), so a leaf
  pop is one row load.
* ``remap (Qp*8,) i32`` — slot ``q*8+j`` -> triangle index into the
  scene's (main-BVH-permuted) arrays; padding slots are 0 and hold
  degenerate triangles the epsilon test rejects.

Entries: internal child -> wide index (>= 0); leaf child -> ``-q - 1``;
empty -> EMPTY_PACKED.

On every device, the CUDA kernel (csrc/subblock_traversal.cu) and its
plain torch version (ops/subblock_traversal.py) read the same tables in a
Hopper layout, packed from these rows once per part at upload
(:func:`pack_k1`; :func:`unpack_k1` gives the rows back bit for bit), the
kernel with 16-byte loads:

* ``nodes (Wp, 64) i32`` — wide node w, 256 bytes:
  - words ``[0, 48)``: the f32 bits of the 8 child boxes as structure of
    arrays, ``lo.x[8], lo.y[8], lo.z[8], hi.x[8], hi.y[8], hi.z[8]``;
  - words ``[48, 56)``: child j's entry (as above);
  - word ``56 + o``: octant o's near-first child order, the slot of rank
    i in bits ``[3i, 3i+3)`` — the row's far-first lanes reversed; ranks
    of empty slots name the empty slots in increasing order.
* ``octets (Qp, 96) f32`` — leaf octet q, 384 bytes: triangle j's
  [v0.xyz, face.xyz, e1.xyz, e2.xyz] at ``[12j, 12j+12)`` (the rows
  without their 4 zero pad floats, the face ahead of the edges: the
  first two 16-byte loads of a triangle give its ``t``, the third its
  barycentrics, which only a triangle nearer than the best hit needs).

Reference behavior matched: per-ray-sized traversal work of the GLSL
stack walk (fragment.glsl:246-307) with near-first child ordering and
`tNear > closestT` pruning (fragment.glsl:261-262).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from opengl_raytracer_torch.ops.bvh import build_bvh

WIDTH = 8
LEAF_TRIS = 8  # one octet per leaf, by construction
ORD0 = 48
EMPTY_PACKED = -(1 << 20)
_BIG = np.float32(1e30)

# Caps of the JAX kernel's packed index words, kept so both packages
# accept the same scenes.
MAX_WIDE_NODES = 1 << 15
MAX_OCTETS = 1 << 16
# Node-stack depth the JAX kernel validates against.  The plain version's
# per-ray stack (ops/subblock_traversal.STACK) holds at most
# (max_depth + 1) * 7 + 1 entries, which this bound keeps under 128; the
# CUDA kernel's stack of node groups at most max_depth + 1 <= 16.
STACK_N = 128


class SubblockTables(NamedTuple):
    node_rows: np.ndarray  # (Wp, 128) f32
    tri_rows: np.ndarray   # (Qp, 128) f32
    remap: np.ndarray      # (Qp*8,) i32
    num_wide: int
    num_octets: int
    max_depth: int


def build_subblock(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                   tri16: np.ndarray, method: str = "sah") -> SubblockTables:
    """Build the sub-block tables over triangles ALREADY in the scene's
    final (main-BVH-permuted) order.  ``tri16 (T, 16)`` carries each
    triangle's [v0, e1, e2, face] padded row.  A separate leaf<=8 binary
    BVH is built here; its permutation is folded into ``remap`` so the
    kernel's winning slot maps straight into the scene arrays."""
    bvh = build_bvh(v0, v1, v2, LEAF_TRIS, method=method)
    N = bvh.num_nodes
    is_leaf = bvh.node_count > 0

    # --- 8-wide collapse with LEAF RE-CHUNKING ---
    # The plain collapse ("expand the internal slot with the largest
    # subtree until 8 slots") stalls once every slot is a leaf: measured on
    # minidragon it left wide nodes averaging 4.0/8 children (690 of 1624
    # nodes had just two) and octets 5.6/8 full — the kernel's fixed
    # 8-slot expand and 8-tri leaf phases then computed on ~30-50%
    # padding.  Binary leaves can't pair-merge (siblings always sum over
    # LEAF_TRIS — a subtree that small would already be one leaf), so
    # densification RE-CHUNKS instead: a wide node's leaf slots pool their
    # triangles, order them along the pool's longest axis, and split into
    # the MINIMAL ceil(total/8) balanced consecutive chunks — each chunk
    # one child slot / one octet with a bbox recomputed from its own
    # triangles.  Re-chunking runs AFTER the DP frontier for a wide node
    # is chosen (it cannot influence which subtrees expand); its wins are
    # (a) fewer slots per node on the margin — the DP's slot counts
    # assume unpacked leaves, so packing occasionally empties a slot —
    # and (b) fuller octets (fewer leaf pushes/pops).  Correctness
    # is unaffected: every triangle stays inside its chunk's bbox, so
    # every intersection is still found; chunk bboxes may overlap more
    # than the binary leaves' did, costing occasional extra leaf pops —
    # measured well under the pop savings (experiments/leaffill.py).
    tri_lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tri_hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    tri_cent = ((v0 + v1 + v2) / 3.0).astype(np.float32)

    span = np.minimum(bvh.node_miss, N) - np.arange(N)
    children: list[list] = []  # slot: int b (internal) | np.ndarray tri ids
    wide_of: dict[int, int] = {}

    def _leaf_ids(b: int) -> np.ndarray:
        first = int(bvh.node_first[b])
        return bvh.perm[first:first + int(bvh.node_count[b])]

    def _split_chunks(ids: np.ndarray, out: list) -> None:
        """Recursive median split of a triangle pool into ceil(n/8) chunks
        of <= 8 — kd-style splits keep chunk bboxes compact (a single-axis
        sort-and-slice interleaves the other two axes and the resulting
        bbox overlap paid back the pop savings on hardware)."""
        n = len(ids)
        if n <= LEAF_TRIS:
            out.append(ids)
            return
        k = -(-n // LEAF_TRIS)
        k1 = (k + 1) // 2
        m = min(k1 * LEAF_TRIS, n - 1)
        c = tri_cent[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        part = np.argsort(c[:, axis], kind="stable")
        _split_chunks(ids[part[:m]], out)
        _split_chunks(ids[part[m:]], out)

    def _rechunk(slots: list) -> list | None:
        """Re-pack the leaf slots into the minimal number of octet groups;
        None when that doesn't free any slot."""
        lk = [k for k, s in enumerate(slots) if isinstance(s, np.ndarray)]
        if len(lk) < 2:
            return None
        all_ids = np.concatenate([slots[k] for k in lk])
        n_chunks = -(-len(all_ids) // LEAF_TRIS)
        if n_chunks >= len(lk):
            return None
        out = [s for k, s in enumerate(slots) if k not in lk]
        _split_chunks(all_ids, out)
        return out

    # Minimal-node-count collapse by dynamic programming (in the spirit of
    # Ylitie et al.'s wide-BVH collapse): h[b][s] = fewest wide nodes that
    # represent binary subtree b as exactly s child slots of its parent
    # (s=1 may wrap b in a wide node of its own; s>=2 splits b's children
    # across the slots with no node for b).  The greedy largest-subtree
    # expansion measured 1572 wide nodes / 3.6-of-8 children on minidragon
    # where this DP yields near the ceil(groups/7) packing bound — node
    # pops per ray drop with the node count.  Computed iteratively in
    # post-order (the binary tree can be deeper than Python's recursion
    # limit on degenerate scenes).
    INF = 1 << 30
    left_of = np.arange(N) + 1
    right_of = np.minimum(bvh.node_miss[np.minimum(left_of, N - 1)], N - 1)
    h = np.full((N, WIDTH + 1), INF, np.int64)
    order = []  # post-order of internal nodes
    st = [0]
    while st:
        b = st.pop()
        if is_leaf[b]:
            h[b, 1] = 0
            continue
        order.append(b)
        st.append(int(left_of[b]))
        st.append(int(right_of[b]))
    split_of = np.zeros((N, WIDTH + 1), np.int64)
    for b in reversed(order):
        hl, hr = h[int(left_of[b])], h[int(right_of[b])]
        for s in range(2, WIDTH + 1):
            best, arg = INF, 0
            for s1 in range(1, s):
                c = hl[s1] + hr[s - s1]
                if c < best:
                    best, arg = c, s1
            h[b, s] = best
            split_of[b, s] = arg
        root_cost = 1 + int(h[b, 2:WIDTH + 1].min())
        if root_cost < h[b, 1]:
            h[b, 1] = root_cost
            split_of[b, 1] = 0  # marker: s=1 means "own wide node"

    def _frontier(b: int, s: int, out: list) -> None:
        """Expand binary node b into s parent slots per the DP tables."""
        if is_leaf[b]:
            out.append(_leaf_ids(b))
            return
        if s == 1:
            out.append(int(b))  # its own wide node (made lazily)
            return
        s1 = int(split_of[b, s])
        _frontier(int(left_of[b]), s1, out)
        _frontier(int(right_of[b]), s - s1, out)

    def make_wide(root: int) -> int:
        """Emit the wide node for binary subtree ``root`` using its optimal
        frontier; leaf slots are then re-chunked into minimal octets."""
        slots: list = []
        if is_leaf[root]:
            slots.append(_leaf_ids(root))
        else:
            # ties prefer the LARGER slot count: same node total, but more
            # direct children = tighter per-child culling and less depth
            vals = h[root, 2:WIDTH + 1]
            s_best = WIDTH - int(np.argmin(vals[::-1]))
            _frontier(int(left_of[root]), int(split_of[root, s_best]), slots)
            _frontier(int(right_of[root]),
                      s_best - int(split_of[root, s_best]), slots)
        packed = _rechunk(slots)
        if packed is not None:
            slots = packed
        children.append(slots)
        return len(children) - 1

    root = make_wide(0)
    queue = [root]
    depth_of = {root: 0}
    max_depth = 0
    qi = 0
    while qi < len(queue):
        w = queue[qi]
        qi += 1
        for b in children[w]:
            if not isinstance(b, np.ndarray):
                cw = make_wide(b)
                wide_of[b] = cw
                depth_of[cw] = depth_of[w] + 1
                max_depth = max(max_depth, depth_of[cw])
                queue.append(cw)

    # --- octet assembly from the re-chunked leaf groups ---
    groups: list[np.ndarray] = []
    group_octet: dict[int, int] = {}  # id(group array) -> octet index
    for slots in children:
        for s in slots:
            if isinstance(s, np.ndarray):
                group_octet[id(s)] = len(groups)
                groups.append(s)
    Q = len(groups)
    if Q >= MAX_OCTETS:
        raise ValueError(f"scene has {Q} leaf octets; sub-block kernel caps "
                         f"at {MAX_OCTETS} (use the packet traversal)")

    Qp = max(-(-Q // 8) * 8, 8)
    remap = np.zeros(Qp * 8, np.int64)
    tri_rows16 = np.zeros((Qp * 8, 16), np.float32)
    for q, ids in enumerate(groups):
        cnt = len(ids)
        remap[q * 8:q * 8 + cnt] = ids
        tri_rows16[q * 8:q * 8 + cnt] = tri16[ids]
    tri_rows = tri_rows16.reshape(Qp, 128)

    W = len(children)
    if W >= MAX_WIDE_NODES:
        raise ValueError(f"{W} wide nodes exceeds the sub-block cap "
                         f"{MAX_WIDE_NODES}")
    if (max_depth + 2) * (WIDTH - 1) + 4 > STACK_N:
        raise ValueError(f"wide depth {max_depth} exceeds the kernel's "
                         f"{STACK_N}-entry node stack")

    Wp = max(-(-W // 8) * 8, 8)
    rows = np.zeros((Wp, 128), np.float32)
    # empty slots: swapped bounds so the slot-form slab test (min from
    # lanes 0-2, max from 3-5, no canonicalization... the kernel computes
    # t1/t2 per axis and min/maxes them, which DOES canonicalize — hence
    # empties can pass; exclusion is via the EMPTY_PACKED push sentinel)
    for j in range(WIDTH):
        rows[:, j * 6:j * 6 + 3] = _BIG
        rows[:, j * 6 + 3:j * 6 + 6] = -_BIG
    rows[:, ORD0:ORD0 + 64] = np.float32(EMPTY_PACKED * 8)

    entry = np.full((W, WIDTH), np.int64(EMPTY_PACKED), np.int64)
    cmin = np.full((W, WIDTH, 3), _BIG, np.float32)
    cmax = np.full((W, WIDTH, 3), -_BIG, np.float32)
    for w, slots in enumerate(children):
        for j, b in enumerate(slots):
            if isinstance(b, np.ndarray):  # leaf group -> one octet; bbox
                mn = tri_lo[b].min(axis=0)  # recomputed from its own tris
                mx = tri_hi[b].max(axis=0)
                ent = -group_octet[id(b)] - 1
            else:
                mn, mx = bvh.node_min[b], bvh.node_max[b]
                ent = wide_of[b]
            cmin[w, j] = mn
            cmax[w, j] = mx
            rows[w, j * 6:j * 6 + 3] = mn
            rows[w, j * 6 + 3:j * 6 + 6] = mx
            entry[w, j] = ent

    # per-octant far-first orders -> packed floats in lanes ORD0..ORD0+64
    centroids = (cmin + cmax) * 0.5  # (W, 8, 3)
    finite = cmin[..., 0] <= cmax[..., 0]
    for o in range(8):
        dsign = np.array([-1.0 if (o >> 2) & 1 else 1.0,
                          -1.0 if (o >> 1) & 1 else 1.0,
                          -1.0 if o & 1 else 1.0], np.float32)
        key = centroids @ dsign
        key = np.where(finite, key, np.inf)  # empties sort first (far end)
        order = np.argsort(-key, axis=1, kind="stable")
        ent_o = np.take_along_axis(entry, order, axis=1)
        packed = np.where(ent_o == EMPTY_PACKED, np.int64(EMPTY_PACKED) * 8,
                          ent_o * 8 + order)
        assert np.abs(packed).max() < (1 << 24)
        rows[:W, ORD0 + o * 8:ORD0 + o * 8 + 8] = packed.astype(np.float32)

    return SubblockTables(
        node_rows=rows,
        tri_rows=tri_rows,
        remap=remap.astype(np.int32),
        num_wide=W,
        num_octets=Qp,
        max_depth=max_depth,
    )


K1_NODE_WORDS = 64
K1_OCTET_FLOATS = 96
K1_ENTRY_WORD = 48  # first child-entry word of a Hopper node
K1_ORDER_WORD = 56  # first order word
# a triangle's 12 floats of a tri_rows lane group, in the octet's order
_K1_TRI = np.array([0, 1, 2, 9, 10, 11, 3, 4, 5, 6, 7, 8])


def pack_k1(node_rows: np.ndarray, tri_rows: np.ndarray
            ) -> tuple[np.ndarray, np.ndarray]:
    """The Hopper layout of one part's tables -> (nodes (Wp, 64) i32,
    octets (Qp, 96) f32); see the module docstring.  Raises ValueError on
    rows whose order lanes are not a per-octant permutation of one set of
    child entries."""
    return pack_nodes(node_rows), pack_octets(tri_rows.reshape(-1, 8, 16))


def unpack_k1(nodes: np.ndarray, octets: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray]:
    """The (node_rows, tri_rows) that :func:`pack_k1` packed."""
    return unpack_nodes(nodes), unpack_octets(octets).reshape(-1, 128)


def pack_octets(tris: np.ndarray) -> np.ndarray:
    """(Q, 8, 16) triangle lane groups [v0, e1, e2, face, 4 pad] -> the
    (Q, 96) Hopper octets [v0, face, e1, e2] per triangle."""
    Q = tris.shape[0]
    return np.ascontiguousarray(
        tris[:, :, _K1_TRI].reshape(Q, K1_OCTET_FLOATS), np.float32)


def unpack_octets(octets: np.ndarray) -> np.ndarray:
    """The (Q, 8, 16) lane groups that :func:`pack_octets` packed (pad
    lanes 0)."""
    Q = octets.shape[0]
    tri = np.zeros((Q, 8, 16), np.float32)
    tri[:, :, _K1_TRI] = octets.reshape(Q, 8, 12)
    return tri


def pack_nodes(node_rows: np.ndarray) -> np.ndarray:
    """Rows of 8-wide nodes (child j's box at lanes ``[6j, 6j+6)``, octant
    o's far-first packed entries at ``ORD0 + 8o``) -> the (W, 64) i32
    Hopper nodes of the module docstring."""
    W = node_rows.shape[0]
    nodes = np.zeros((W, K1_NODE_WORDS), np.int32)
    boxes = np.ascontiguousarray(node_rows[:, :48], np.float32)
    nodes[:, :48] = boxes.reshape(W, 8, 6).transpose(0, 2, 1).reshape(
        W, 48).view(np.int32)
    packed = node_rows[:, ORD0:ORD0 + 64].astype(np.int64).reshape(W, 8, 8)
    if not np.array_equal(packed.astype(np.float32),
                          node_rows[:, ORD0:ORD0 + 64].reshape(W, 8, 8)):
        raise ValueError("order lanes are not exact integers")
    empty = packed == np.int64(EMPTY_PACKED) * 8
    ent, slot = packed >> 3, packed & 7
    entry = np.full((W, 8), EMPTY_PACKED, np.int64)
    w_idx = np.nonzero(~empty)[0]
    s_idx = slot[~empty]
    e_idx = ent[~empty]
    entry[w_idx, s_idx] = e_idx
    if not np.array_equal(entry[w_idx, s_idx], e_idx):
        raise ValueError("octants disagree on a child entry")
    near_first = slot[:, :, ::-1].copy()  # pop order: last push lane first
    hole = empty[:, :, ::-1]
    free = entry == EMPTY_PACKED
    n_free = free.sum(axis=1)
    if not (hole.sum(axis=2) == n_free[:, None]).all():
        raise ValueError("an octant's order is not a permutation of its "
                         "node's children")
    # empty ranks name the empty slots in increasing order
    free_slots = np.argsort(~free, axis=1, kind="stable")  # (W, 8)
    hole_ranks = np.argsort(~hole, axis=2, kind="stable")  # (W, 8, 8)
    for k in range(8):
        w_k, o_k = np.nonzero(n_free[:, None].repeat(8, 1) > k)
        near_first[w_k, o_k, hole_ranks[w_k, o_k, k]] = free_slots[w_k, k]
    if not (np.sort(near_first, axis=2) == np.arange(8)).all():
        raise ValueError("order lanes are not a permutation of the slots")
    nodes[:, K1_ENTRY_WORD:K1_ORDER_WORD] = entry
    word = (near_first << (3 * np.arange(8))).sum(axis=2)
    nodes[:, K1_ORDER_WORD:] = word.astype(np.int32)
    return nodes


def unpack_nodes(nodes: np.ndarray) -> np.ndarray:
    """The (W, 128) node rows that :func:`pack_nodes` packed (lanes past
    the order lanes 0)."""
    W = nodes.shape[0]
    rows = np.zeros((W, 128), np.float32)
    rows[:, :48] = np.ascontiguousarray(nodes[:, :48]).view(
        np.float32).reshape(W, 6, 8).transpose(0, 2, 1).reshape(W, 48)
    entry = nodes[:, K1_ENTRY_WORD:K1_ORDER_WORD].astype(np.int64)
    word = nodes[:, K1_ORDER_WORD:].astype(np.int64) & 0xFFFFFF
    near_first = (word[:, :, None] >> (3 * np.arange(8))) & 7
    slot = near_first[:, :, ::-1]  # back to far-first push lanes
    ent = np.take_along_axis(entry[:, None, :].repeat(8, 1), slot, axis=2)
    packed = np.where(ent == EMPTY_PACKED, np.int64(EMPTY_PACKED) * 8,
                      ent * 8 + slot)
    rows[:, ORD0:ORD0 + 64] = packed.reshape(W, 64).astype(np.float32)
    return rows


TABLE_BUDGET_BYTES = 7_864_320  # 7.5 MB
"""Per-part sub-block table budget.  It is the JAX kernel's on-chip memory
budget; :func:`build_subblock_parts` keeps it, and the JAX package's cap
of 16 parts, as its defaults, so that at them both packages split a scene
into the same parts."""

CARD_TABLE_BUDGET_BYTES = 4 * TABLE_BUDGET_BYTES  # 30 MB
"""The per-part budget ``Scene`` builds at.  The CUDA kernel reads its
tables from device memory, so nothing bounds a part but the index caps
(``MAX_OCTETS``, ``MAX_WIDE_NODES``); at 30 MB a part fits the H100's
50 MB L2 with room for the rays' state."""

CARD_MAX_PARTS = 4
"""The part cap ``Scene`` builds at: with :data:`CARD_TABLE_BUDGET_BYTES`
the whole tables stay under the JAX split's 16 x 7.5 MB."""


def _part_sizes(T: int, n_parts: int) -> list[int]:
    """The triangle counts of :func:`build_subblock_parts`' split of ``T``
    triangles into ``n_parts``, in part order: its median halving depends
    on the counts alone."""
    sizes = [T]
    while len(sizes) < n_parts:
        nxt = []
        for n in sizes:
            nxt += [n] if n < 16 else [n // 2, n - n // 2]
        if len(nxt) == len(sizes):
            break
        sizes = nxt
    return sizes


def _least_part_bytes(n: int) -> int:
    """A lower bound of the node and octet rows :func:`build_subblock`
    makes of ``n`` triangles: ceil(n / 8) octets (an octet holds 8) and a
    root node, each table padded as it pads them."""
    octets = -(-n // LEAF_TRIS)
    return (max(-(-octets // 8) * 8, 8) + 8) * 512


def build_subblock_parts(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                         tri16: np.ndarray, method: str = "sah",
                         budget_bytes: int = TABLE_BUDGET_BYTES,
                         max_parts: int = 16,
                         stats: dict | None = None
                         ) -> tuple[SubblockTables, ...]:
    """Partitioned sub-block tables for scenes whose tables exceed
    ``budget_bytes``.

    Triangles are split spatially (recursive centroid-median halving along
    the largest axis) into the fewest parts whose per-part tables fit
    ``budget_bytes``; each part is an independent sub-block BVH over the
    SAME global triangle index space (remap is rebased), so the traversal
    can chain parts with cross-part ``best_t`` pruning and a strict-``<``
    host combine.

    A split is refused before anything is built where a part's least
    bytes (:func:`_least_part_bytes`) are over budget or its least octets
    reach ``MAX_OCTETS``: the built part would raise as well, so the
    result, tables or raise, is the JAX package's at any budget.

    ``stats``, when given, is filled with what the build did: ``parts``
    (the parts returned; 0 when it raises), ``rounds`` (the splits tried,
    the first included), ``largest_part_bytes`` (node rows plus octet
    rows of the largest part; when it raises, of the part over budget, or
    its least bytes where the bound refused it), ``budget_bytes`` and
    ``max_parts``.
    """
    stats = {} if stats is None else stats
    stats.update(parts=0, rounds=0, largest_part_bytes=0,
                 budget_bytes=budget_bytes, max_parts=max_parts)
    T = v0.shape[0]
    est_bytes = ((T // 8 + 1) + (T // 4 + 1)) * 512  # tri rows + node rows, rough
    n_parts = 1
    while (est_bytes / n_parts > budget_bytes * 0.8 and n_parts < max_parts):
        n_parts *= 2

    while True:
        stats["rounds"] += 1
        try:
            for n in _part_sizes(T, n_parts):
                least = _least_part_bytes(n)
                if least > budget_bytes or -(-n // LEAF_TRIS) >= MAX_OCTETS:
                    stats["largest_part_bytes"] = least
                    raise ValueError(f"a part of {n} triangles takes at "
                                     f"least {least} bytes")
            # spatial partition: recursive median split on centroids
            centroids = (v0 + v1 + v2) / 3.0
            parts_idx = [np.arange(T, dtype=np.int64)]
            while len(parts_idx) < n_parts:
                nxt = []
                for idx in parts_idx:
                    if len(idx) < 16:
                        nxt.append(idx)
                        continue
                    c = centroids[idx]
                    axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
                    order = np.argsort(c[:, axis], kind="stable")
                    half = len(idx) // 2
                    nxt.append(idx[order[:half]])
                    nxt.append(idx[order[half:]])
                if len(nxt) == len(parts_idx):
                    break  # every part < 16 tris: splitting can make no progress
                parts_idx = nxt

            tables = []
            for idx in parts_idx:
                if len(idx) == 0:
                    continue
                t = build_subblock(v0[idx], v1[idx], v2[idx], tri16[idx],
                                   method=method)
                nbytes = t.node_rows.nbytes + t.tri_rows.nbytes
                if nbytes > budget_bytes:
                    stats["largest_part_bytes"] = nbytes
                    raise ValueError(f"part tables {nbytes} over budget")
                tables.append(t._replace(
                    remap=idx[t.remap].astype(np.int32)))
            stats["parts"] = len(tables)
            stats["largest_part_bytes"] = max(
                t.node_rows.nbytes + t.tri_rows.nbytes for t in tables)
            return tuple(tables)
        except ValueError:
            if n_parts >= max_parts:
                raise
            n_parts *= 2


def validate_subblock(tables: SubblockTables) -> None:
    """The sub-block tables' checker
    (``opengl_raytracer_tpu/ops/wide2.py:394``, whose triangle count
    argument goes unused, so the port takes none); raises AssertionError
    when an octet is reachable twice from the root through the packed
    push orders (octant 0's lanes), or a triangle (face != 0; padding
    triangles are zero) appears twice across the reachable octets."""
    seen_oct = []
    stack = [0]
    rows = tables.node_rows
    while stack:
        w = stack.pop()
        for p in rows[w, ORD0:ORD0 + 8].astype(np.int64):
            p = int(p)
            if p == EMPTY_PACKED * 8:
                continue
            ent = p >> 3
            if ent >= 0:
                stack.append(ent)
            else:
                seen_oct.append(-ent - 1)
    assert len(seen_oct) == len(set(seen_oct)), "duplicate octet reachability"
    tri_seen = sorted(
        int(tables.remap[q * 8 + j])
        for q in seen_oct
        for j in range(8)
        if np.any(tables.tri_rows[q, j * 16 + 9:j * 16 + 12]))
    assert len(tri_seen) == len(set(tri_seen)), "triangle appears twice"
