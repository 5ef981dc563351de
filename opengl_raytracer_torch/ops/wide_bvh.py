"""8-wide BVH tables of the wide-BVH traversal kernel (K3).

A NumPy copy of ``opengl_raytracer_tpu/ops/wide_bvh.py`` (``collapse_wide``,
``validate_wide``, ``encode_leaf`` and their constants), so that both
packages build bit-identical tables and their nearest hits can be compared
ray by ray.  The layout was shaped for the TPU's (8, 128) tiles.  Here it
is the builder's output, what the tests hold against the JAX package, and
the packer's input; no device holds it:

* ``tiles (ceil(W/8), 8, 128) f32`` — child j of wide node w at tile
  ``w//8``, row j, lanes ``(w%8)*16 + 0..5`` as [bmin.xyz, bmax.xyz]; at
  lane ``(w%8)*16 + ORD_LANE0 + o``, row i, the rank-i far-first push
  entry for direction octant o, packed as the exact-integer float
  ``entry*8 + j``.  Empty child slots hold FINITE swapped (+big, -big)
  boxes, which pass the min/max slab test: only the EMPTY_PACKED sentinel
  keeps them off the stack.
* ``entry (W, 8) i32`` — the child entries in slot order (validation and
  the stack bound): internal child -> its wide index (>= 0); leaf child ->
  ``-first_octet - 1`` (< 0); empty -> EMPTY_ENTRY.

On every device, the K3 kernel (csrc/wide_traversal.cu) and its plain
torch version (ops/pallas_traversal.py) read the same tree in a Hopper
layout, packed from the tiles once at upload (:func:`pack_k3`, inverse
:func:`unpack_k3`; ``SceneData.k3``), the kernel with 16-byte loads, the
layout of K1's tables (ops/wide2.py):

* ``nodes (W, 64) i32`` — wide node w, 256 bytes: the 8 child boxes as
  structure of arrays (words ``[0, 48)``: ``lo.x[8] ... hi.z[8]``), the 8
  child entries (words ``[48, 56)``: ``>= 0`` a wide node,
  ``-(q << 10 | (n - 1)) - 1`` the leaf of n triangles starting at octet
  q (:func:`encode_k3_leaf`), EMPTY_PACKED an empty slot), and per octant
  the near-first slot order, 3 bits a rank (word ``56 + o``, bits
  ``[0, 24)``: the tile's far-first push lanes reversed; bits ``[24, 32)``
  the mask of the non-empty slots, the same in every octant's word, so a
  visit needs no entry to close an empty slot).  Only the W real nodes
  are kept: the tiles' padding groups past them are rebuilt by
  :func:`unpack_k3`.
* ``octets (Q, 96) f32`` — octet q (slots ``8q .. 8q+7``), 384 bytes:
  triangle j's [v0, face, e1, e2] at ``[12j, 12j+12)``, so the first two
  16-byte loads of a triangle give its ``t``; 48 bytes a slot against the
  tiles' 64.

A tile entry names only a leaf's first octet, so the JAX kernel tests a
fixed ``ceil(max_leaf / 8)`` octets at every leaf, reading into the next
leaves' triangles.  K3's entry also holds the leaf's own triangle count,
taken from the scene's ``node_count`` (:func:`leaf_counts`), and K3 tests
exactly that leaf's triangles.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from opengl_raytracer_torch.ops.bvh import BVH
from opengl_raytracer_torch.ops.wide2 import (pack_nodes, pack_octets,
                                              unpack_nodes, unpack_octets)

WIDTH = 8
EMPTY_ENTRY = np.int32(-(2**31))
# Triangles per leaf octet of the triangle tiles (models/scene.py): leaves
# start on octet boundaries, and a leaf entry names its first octet.
TRIS_PER_OCTET = 8


class WideBVH(NamedTuple):
    tiles: np.ndarray  # (ceil(W/8), 8, 128) f32
    entry: np.ndarray  # (W, 8) i32 (slot order)
    num_nodes: int
    max_depth: int  # of the wide tree
    max_stack: int  # safe per-ray stack bound: (max_depth + 2) * 7 + 4


# Lane layout of a node's 16-lane group, per child row j: lanes 0-2 bmin,
# 3-5 bmax, 6-13 the per-octant ordered push entries, 14-15 pad.
ORD_LANE0 = 6

# Ordered push entries are exact-integer float32 values (entry * 8 + slot),
# exact below 2^24, so |entry| must stay under 2^21.
PACK_LIMIT = 1 << 21
EMPTY_PACKED = -(1 << 20)  # decoded entry sentinel for empty slots
MAX_STACK = 512  # the JAX kernel's stack; deeper trees are rejected
# K3's leaf entry: the first octet above LEAF_COUNT_BITS bits of count - 1.
LEAF_COUNT_BITS = 10
MAX_LEAF_COUNT = 1 << LEAF_COUNT_BITS


def encode_leaf(first_octet: int, count: int) -> int:
    # The tiles' entry, as the JAX package encodes it: only the octet
    # start.  Leaf padding slots are degenerate triangles the epsilon test
    # rejects, and the JAX kernel's fixed-octet over-read past a short leaf
    # tests neighbouring REAL triangles, which is harmless for a nearest-hit
    # query.  K3's own entry adds the count (encode_k3_leaf).
    del count
    return -first_octet - 1


def encode_k3_leaf(first_octet, count):
    """K3's leaf entry (scalars or int64 arrays): ``-(first_octet << 10 |
    (count - 1)) - 1``, negative like the tiles' entry."""
    return -((first_octet << LEAF_COUNT_BITS) | (count - 1)) - 1


def decode_k3_leaf(entry):
    """(first octet, count) of K3's leaf entry (scalars or int64 arrays)."""
    e = -entry - 1
    return e >> LEAF_COUNT_BITS, (e & (MAX_LEAF_COUNT - 1)) + 1


def leaf_counts(node_count: np.ndarray, n_octets: int) -> np.ndarray:
    """Per octet q (Q,) int64: the triangle count of the leaf that starts at
    q, 0 where none starts.  Leaves lie in the binary BVH's preorder, each
    from an octet boundary, in ``models/scene.py``'s triangle tiles."""
    counts = np.asarray(node_count).astype(np.int64)
    counts = counts[counts > 0]
    first = np.concatenate(([0], np.cumsum(-(-counts // TRIS_PER_OCTET))))
    if first[-1] > n_octets:
        raise ValueError(f"the leaves need {first[-1]} octets, the table "
                         f"holds {n_octets}")
    out = np.zeros(n_octets, np.int64)
    out[first[:-1]] = counts
    return out


def stack_bound(max_depth: int) -> int:
    return (max_depth + 2) * (WIDTH - 1) + 4


def collapse_wide(bvh: BVH, leaf_first_octet: np.ndarray) -> WideBVH:
    """Collapse a binary BVH (ops/bvh.py layout) into the 8-wide layout.

    ``leaf_first_octet``: per binary node, the first octet of its leaf in
    the octet-aligned triangle table (meaningful for leaves only)."""
    N = bvh.num_nodes
    # Binary children from the preorder + miss links: internal node i has
    # left = i + 1 and right = miss[left].
    is_leaf = bvh.node_count > 0
    # Subtree sizes: the subtree of i spans [i, min(miss[i], N)).
    span = np.minimum(bvh.node_miss, N) - np.arange(N)

    children: list[list[int]] = []  # wide node -> binary node ids
    wide_of_binary: dict[int, int] = {}

    def make_wide(binary_root: int) -> int:
        """A wide node whose slots cover binary_root's subtree: expand the
        internal slot with the largest subtree until 8 slots are filled."""
        slots = [int(binary_root)]
        while len(slots) < WIDTH:
            best, best_size = -1, 0
            for k, b in enumerate(slots):
                if not is_leaf[b] and span[b] > best_size:
                    best, best_size = k, int(span[b])
            if best < 0:
                break
            b = slots.pop(best)
            left = b + 1
            slots.extend([left, int(bvh.node_miss[left])])
        children.append(slots)
        return len(children) - 1

    # BFS, so wide indices are allocated root first.
    root = make_wide(0)
    queue = [root]
    depth_of = {root: 0}
    max_depth = 0
    qi = 0
    while qi < len(queue):
        w = queue[qi]
        qi += 1
        for b in children[w]:
            if not is_leaf[b]:
                cw = make_wide(b)
                wide_of_binary[b] = cw
                depth_of[cw] = depth_of[w] + 1
                max_depth = max(max_depth, depth_of[cw])
                queue.append(cw)

    W = len(children)
    Wp = -(-W // 8) * 8
    tiles = np.zeros((Wp // 8, 8, 128), np.float32)
    far = np.float32(1e30)
    for g in range(8):
        tiles[:, :, g * 16:g * 16 + 3] = far
        tiles[:, :, g * 16 + 3:g * 16 + 6] = -far
    entry = np.full((W, 8), EMPTY_ENTRY, np.int32)

    for w, slots in enumerate(children):
        tile, group = w // 8, (w % 8) * 16
        for j, b in enumerate(slots):
            tiles[tile, j, group:group + 3] = bvh.node_min[b]
            tiles[tile, j, group + 3:group + 6] = bvh.node_max[b]
            if is_leaf[b]:
                entry[w, j] = encode_leaf(int(leaf_first_octet[b]),
                                          int(bvh.node_count[b]))
            else:
                entry[w, j] = wide_of_binary[b]

    if W >= PACK_LIMIT // 8:
        raise ValueError(f"wide BVH too large to pack ordered entries ({W})")
    max_octet = int(leaf_first_octet.max()) if len(leaf_first_octet) else 0
    if max_octet >= -EMPTY_PACKED - 1:
        raise ValueError(f"leaf octet index {max_octet} collides with the "
                         f"empty-slot sentinel")
    max_stack = stack_bound(max_depth)
    if max_stack > MAX_STACK:
        raise ValueError(
            f"wide BVH worst-case stack {max_stack} exceeds the kernel's "
            f"{MAX_STACK}-entry stack (pathologically deep tree)")

    centroids = np.zeros((W, WIDTH, 3), np.float32)
    finite = np.zeros((W, WIDTH), bool)
    for w in range(W):
        tile, group = w // 8, (w % 8) * 16
        lo = tiles[tile, :, group:group + 3]
        hi = tiles[tile, :, group + 3:group + 6]
        centroids[w] = (lo + hi) * 0.5
        finite[w] = lo[:, 0] <= hi[:, 0]

    # Per-octant far-first push order: a LIFO stack pops the last push
    # first, so far-to-near pushes give near-first traversal.
    packed_empty = EMPTY_PACKED * 8
    for o in range(8):
        d = np.array([-1.0 if (o >> 2) & 1 else 1.0,
                      -1.0 if (o >> 1) & 1 else 1.0,
                      -1.0 if o & 1 else 1.0], np.float32)
        key = centroids @ d  # (W, 8)
        key = np.where(finite, key, np.inf)  # empty slots sorted first
        order = np.argsort(-key, axis=1, kind="stable")  # far first
        ent_o = np.take_along_axis(entry, order, axis=1).astype(np.int64)
        packed = np.where(ent_o == np.int64(EMPTY_ENTRY), packed_empty,
                          ent_o * 8 + order)
        assert np.abs(packed).max() < (1 << 24)
        for w in range(W):
            tile, group = w // 8, (w % 8) * 16
            tiles[tile, :, group + ORD_LANE0 + o] = packed[w].astype(np.float32)

    return WideBVH(tiles=tiles, entry=entry, num_nodes=W,
                   max_depth=max_depth, max_stack=max_stack)


def wide_max_stack(entry: np.ndarray) -> int:
    """The per-ray stack bound of a wide tree given by its ``entry`` table:
    collapse_wide's ``max_stack``, recomputed from the tree's depth."""
    depth = np.zeros(entry.shape[0], np.int64)
    max_depth = 0
    for w in range(entry.shape[0]):  # BFS order: parents come first
        for e in entry[w]:
            if e >= 0:
                depth[e] = depth[w] + 1
                max_depth = max(max_depth, int(depth[e]))
    return stack_bound(max_depth)


def wide_depth(max_stack: int) -> int:
    """The wide tree's depth, from its stack bound (:func:`stack_bound`)."""
    return (max_stack - 4) // (WIDTH - 1) - 2


_FAR = np.float32(1e30)


def _padding_group() -> np.ndarray:
    """A tile's (8, 16) lane group past the last wide node."""
    g = np.zeros((8, 16), np.float32)
    g[:, 0:3], g[:, 3:6] = _FAR, -_FAR
    return g


def pack_k3(pw_tiles: np.ndarray, pl_tri_tiles: np.ndarray,
            node_count: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """K3's Hopper layout of the wide tiles -> (nodes (W, 64) i32, octets
    (Q, 96) f32); see the module docstring.  Each leaf entry gets its
    leaf's triangle count from ``node_count``, the binary BVH's.  Raises
    ValueError on tiles the layout cannot give back bit for bit: pad lanes
    that are not 0, padding groups between nodes, order lanes that are not
    a per-octant permutation of one set of child entries; and on a leaf
    entry it cannot encode: no leaf starts at its octet, the octet is not
    under ``PACK_LIMIT - 1`` or the count is over ``MAX_LEAF_COUNT``."""
    groups = np.ascontiguousarray(
        np.asarray(pw_tiles, np.float32).reshape(-1, 8, 8, 16)
        .transpose(0, 2, 1, 3)).reshape(-1, 8, 16)  # [w, row, lane]
    bits = groups.view(np.int32)
    if bits[:, :, 14:].any():
        raise ValueError("pw_tiles pad lanes 14-15 are not 0")
    real = bits[:, :, ORD_LANE0:ORD_LANE0 + 8].any(axis=(1, 2))
    W = int(real.sum())
    if not real[:W].all() or not (
            bits[W:] == _padding_group().view(np.int32)).all():
        raise ValueError("pw_tiles holds padding groups between wide nodes")
    rows = np.zeros((W, 128), np.float32)
    rows[:, :48] = groups[:W, :, 0:6].reshape(W, 48)
    # order lanes: octant o, rank i at ORD0 + 8o + i
    rows[:, 48:112] = groups[:W, :, ORD_LANE0:ORD_LANE0 + 8].transpose(
        0, 2, 1).reshape(W, 64)
    tris = np.ascontiguousarray(
        np.asarray(pl_tri_tiles, np.float32).reshape(-1, 8, 8, 16)
        .transpose(0, 2, 1, 3)).reshape(-1, 8, 16)  # [octet, triangle, lane]
    if tris.view(np.int32)[:, :, 12:].any():
        raise ValueError("pl_tri_tiles pad lanes 12-15 are not 0")
    nodes = pack_nodes(rows)
    entries = nodes[:, 48:56].astype(np.int64)
    full = entries != EMPTY_PACKED
    mask = (full.astype(np.int64) << np.arange(8)).sum(axis=1)
    words = nodes[:, 56:64].astype(np.int64) | (mask[:, None] << 24)
    nodes[:, 56:64] = words.astype(np.uint32).view(np.int32)
    leaf = full & (entries < 0)
    first = -entries[leaf] - 1
    last = int(first.max(initial=-1))
    if last >= PACK_LIMIT - 1:
        raise ValueError(f"leaf octet {last} does not fit K3's leaf entry "
                         f"(under {PACK_LIMIT - 1})")
    counts = leaf_counts(node_count, tris.shape[0])
    if last >= counts.shape[0]:
        raise ValueError("a leaf entry starts past the octet table")
    n = counts[first]
    if (n == 0).any():
        raise ValueError("a leaf entry starts at an octet no leaf starts at")
    if (n > MAX_LEAF_COUNT).any():
        raise ValueError(f"a leaf of {int(n.max())} triangles does not fit "
                         f"K3's leaf entry (at most {MAX_LEAF_COUNT})")
    entries[leaf] = encode_k3_leaf(first, n)
    nodes[:, 48:56] = entries.astype(np.int32)
    return nodes, pack_octets(tris)


def unpack_k3(nodes: np.ndarray, octets: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray]:
    """The (pw_tiles, pl_tri_tiles) that :func:`pack_k3` packed: the leaf
    entries back to the tiles' first octets, the slot mask dropped."""
    W = nodes.shape[0]
    Wp = -(-W // 8) * 8
    word = nodes[:, 56:64].astype(np.int64) & 0xFFFFFFFF
    full = ((word[:, :1] >> (24 + np.arange(8))) & 1).astype(bool)
    entries = nodes[:, 48:56].astype(np.int64)
    leaf = full & (entries < 0)
    entries[leaf] = -decode_k3_leaf(entries[leaf])[0] - 1
    tiles_nodes = nodes.copy()
    tiles_nodes[:, 48:56] = entries
    rows = unpack_nodes(tiles_nodes)
    groups = np.repeat(_padding_group()[None], Wp, axis=0)
    groups[:W, :, 0:6] = rows[:, :48].reshape(W, 8, 6)
    groups[:W, :, ORD_LANE0:ORD_LANE0 + 8] = rows[:, 48:112].reshape(
        W, 8, 8).transpose(0, 2, 1)
    pw_tiles = (groups.reshape(-1, 8, 8, 16).transpose(0, 2, 1, 3)
                .reshape(-1, 8, 128))
    tris = unpack_octets(octets)
    pl_tri_tiles = (tris.reshape(-1, 8, 8, 16).transpose(0, 2, 1, 3)
                    .reshape(-1, 8, 128))
    return pw_tiles, pl_tri_tiles


def validate_wide(wide: WideBVH, bvh: BVH) -> None:
    """Every binary leaf must be reachable exactly once via wide entries."""
    is_leaf = bvh.node_count > 0
    seen = []
    stack = [0]
    while stack:
        w = stack.pop()
        for e in wide.entry[w]:
            e = int(e)
            if e == int(EMPTY_ENTRY):
                continue
            if e >= 0:
                stack.append(e)
            else:
                seen.append(e)
    assert len(seen) == int(is_leaf.sum()), (len(seen), int(is_leaf.sum()))
    assert len(set(seen)) == len(seen), "duplicate leaf entries"
