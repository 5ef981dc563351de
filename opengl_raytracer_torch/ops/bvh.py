"""BVH construction (host side; a NumPy copy of ``opengl_raytracer_tpu/ops/bvh.py``).

A top-down binary BVH in DFS preorder with miss links, plus the triangle
permutation that makes leaves contiguous ranges (reference:
boundingBoxes.pyx:9-132, scene.py:148-221).  The C++ builder
(``native/loader.py``) is preferred, with binned SAH splits; without a
compiler the pure-NumPy centroid-mean builder below runs instead.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class BVH(NamedTuple):
    """Flattened BVH in DFS preorder with miss links (host numpy arrays)."""

    node_min: np.ndarray  # (N, 3) float32 AABB lower corners
    node_max: np.ndarray  # (N, 3) float32 AABB upper corners
    node_miss: np.ndarray  # (N,) int32; jump target on AABB miss / after leaf
    node_first: np.ndarray  # (N,) int32; first triangle (permuted order), leaves
    node_count: np.ndarray  # (N,) int32; triangles in leaf, 0 for internal
    perm: np.ndarray  # (T,) int64; permuted-order -> original triangle index
    depth: int  # maximum node depth (root = 0)

    @property
    def num_nodes(self) -> int:
        return int(self.node_miss.shape[0])


last_builder: str | None = None  # "native" or "numpy": the last build_bvh's


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              max_leaf_tris: int = 16, method: str = "sah",
              prefer_native: bool = True,
              progress: bool | None = None) -> BVH:
    """Build a BVH over triangles given as three (T, 3) arrays.

    method: "mean" (the reference's centroid-mean split) or "sah" (binned
    surface-area heuristic; native builder only).  Falls back to the NumPy
    mean-split builder when the native library cannot be built or fails.
    ``last_builder`` records which of the two ran ("native" or "numpy").
    ``progress`` prints the reference's carriage-return percent bar during
    the build (boundingBoxes.pyx:64-65); default auto (utils/progress.py).
    """
    from opengl_raytracer_torch.utils.progress import progress_enabled

    global last_builder
    show = progress_enabled(progress)
    if prefer_native:
        try:
            from opengl_raytracer_torch.native import loader

            bvh = loader.build_bvh_native(
                v0, v1, v2, max_leaf_tris, method=1 if method == "sah" else 0,
                progress=show)
            if bvh is not None:
                last_builder = "native"
                return bvh
        except Exception:
            pass
    last_builder = "numpy"
    return build_bvh_numpy(v0, v1, v2, max_leaf_tris, progress=show)


def build_bvh_numpy(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                    max_leaf_tris: int = 16, progress: bool = False) -> BVH:
    """Pure-NumPy mean-split builder (the readable spec of the native one)."""
    T = v0.shape[0]
    if T == 0:
        raise ValueError("cannot build a BVH over zero triangles")

    centroids = (v0 + v1 + v2) / 3.0
    tri_min = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tri_max = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)

    node_min: list[np.ndarray] = []
    node_max: list[np.ndarray] = []
    node_first: list[int] = []
    node_count: list[int] = []
    node_children: list[tuple[int, int]] = []  # (-1, -1) for leaves
    node_depth: list[int] = []
    perm_chunks: list[np.ndarray] = []
    perm_offset = 0

    # Explicit DFS stack of (triangle index set, depth, parent slot).
    all_idx = np.arange(T, dtype=np.int64)
    stack: list[tuple[np.ndarray, int, tuple[int, int] | None]] = [
        (all_idx, 0, None)]

    while stack:
        idx, depth, parent = stack.pop()
        me = len(node_count)
        node_min.append(tri_min[idx].min(axis=0))
        node_max.append(tri_max[idx].max(axis=0))
        node_depth.append(depth)
        if parent is not None:
            pnode, slot = parent
            a, b = node_children[pnode]
            node_children[pnode] = (me, b) if slot == 0 else (a, me)

        n = idx.shape[0]
        if n <= max_leaf_tris:
            node_first.append(perm_offset)
            node_count.append(n)
            node_children.append((-1, -1))
            perm_chunks.append(idx)
            perm_offset += n
            if progress and (perm_offset * 100) // T != ((perm_offset - n)
                                                         * 100) // T:
                # percent of triangles placed into finished leaves
                print(f"\r{round(perm_offset / T * 100, 2)}%...",
                      end="", flush=True)
            continue

        cent = centroids[idx]
        extent = cent.max(axis=0) - cent.min(axis=0)
        axis = int(np.argmax(extent))
        mean = cent[:, axis].mean()
        mask = cent[:, axis] <= mean
        left, right = idx[mask], idx[~mask]
        if left.size == 0 or right.size == 0:
            # Degenerate (identical centroids on the axis): even index split.
            half = n // 2
            left, right = idx[:half], idx[half:]

        node_first.append(-1)
        node_count.append(0)
        node_children.append((0, 0))  # patched when children pop
        # Push right first so left is visited first (preorder: left = me + 1).
        stack.append((right, depth + 1, (me, 1)))
        stack.append((left, depth + 1, (me, 0)))

    if progress:
        print("")

    N = len(node_count)
    # Miss links: miss[root] = N; for internal node i with children (l, r):
    # miss[l] = r, miss[r] = miss[i].
    miss = np.full(N, N, dtype=np.int32)
    order = np.argsort(node_depth, kind="stable")  # parents before children
    for i in order:
        l, r = node_children[i]
        if l != -1:
            miss[l] = r
            miss[r] = miss[i]

    return BVH(
        node_min=np.asarray(node_min, dtype=np.float32),
        node_max=np.asarray(node_max, dtype=np.float32),
        node_miss=miss,
        node_first=np.asarray(node_first, dtype=np.int32),
        node_count=np.asarray(node_count, dtype=np.int32),
        perm=np.concatenate(perm_chunks),
        depth=int(max(node_depth)),
    )


def validate_bvh(bvh: BVH, v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                 max_leaf_tris: int) -> None:
    """The builder's checker (``opengl_raytracer_tpu/ops/bvh.py:184``);
    raises AssertionError when an invariant fails: every triangle lies in
    exactly one leaf, every leaf's box holds its triangles (to 1e-4), leaf
    sizes lie in [1, max_leaf_tris], miss links point forward and no
    further than the end, and an internal node's first child (i + 1, DFS
    preorder) exists."""
    N = bvh.num_nodes
    T = v0.shape[0]
    assert sorted(bvh.perm.tolist()) == list(range(T)), \
        "perm is not a permutation"

    leaves = bvh.node_count > 0
    counts = bvh.node_count[leaves]
    assert counts.min() >= 1 and counts.max() <= max_leaf_tris

    covered = np.zeros(T, dtype=bool)
    for i in np.nonzero(leaves)[0]:
        first, cnt = int(bvh.node_first[i]), int(bvh.node_count[i])
        tris = bvh.perm[first:first + cnt]
        assert not covered[tris].any(), "triangle in two leaves"
        covered[tris] = True
        for arr in (v0, v1, v2):
            pts = arr[tris]
            assert (pts >= bvh.node_min[i] - 1e-4).all()
            assert (pts <= bvh.node_max[i] + 1e-4).all()
    assert covered.all(), "triangle missing from all leaves"

    idxs = np.arange(N, dtype=np.int32)
    assert (bvh.node_miss > idxs).all() and (bvh.node_miss <= N).all()
    internal = ~leaves
    assert ((idxs + 1)[internal] < N).all()
