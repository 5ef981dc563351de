"""Scene compiler: scene-graph objects -> the device tables the renderer reads.

Flattening, the per-object material broadcast, the BVH permutation and
every table follow ``opengl_raytracer_tpu/models/scene.py`` line for line
(reference: scene.py:9-236), so both packages build bit-identical tables
from the same objects, but for the sub-block parts: they are split at the
card's budget (``ops/wide2.CARD_TABLE_BUDGET_BYTES``, at most
``CARD_MAX_PARTS``), so a scene the JAX package splits may take fewer
parts here.  :meth:`Scene.fields` gives those tables in the JAX package's
layout, the TPU's; they are the builder's output, the packers' input and
what the tests compare with the JAX package.  :meth:`Scene.send` packs
each table once into the layout its kernel reads, and uploads that copy
only; on every device the kernel and its plain version read it:

* the triangle records ``tri_records`` (brute force, ops/intersect.py;
  the BVH walks, ops/traversal.py) and the binary BVH's node records
  ``node_records`` (the BVH walks);
* K3's wide BVH and triangle octets (``k3``, ops/wide_bvh.pack_k3) and
  the aligned slot -> triangle map ``pl_remap`` (ops/pallas_traversal.py);
* per sub-block part, K1's nodes, octets and slot -> triangle map
  (``k1_parts``, ops/wide2.pack_k1; ops/subblock_traversal.py);
* the shading rows, in triangle order (``sh_abc``) and in sub-block slot
  order (``sh_slot``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opengl_raytracer_torch.ops import bvh as bvh_mod
from opengl_raytracer_torch.ops.intersect import pack_tri_records
from opengl_raytracer_torch.ops.traversal import pack_node_records
from opengl_raytracer_torch.ops.wide2 import (CARD_MAX_PARTS,
                                              CARD_TABLE_BUDGET_BYTES,
                                              build_subblock_parts, pack_k1)
from opengl_raytracer_torch.ops.wide_bvh import (MAX_LEAF_COUNT,
                                                 TRIS_PER_OCTET, collapse_wide,
                                                 pack_k3, wide_max_stack)
from opengl_raytracer_torch.utils import profiling


class SceneData(NamedTuple):
    """Device-resident scene: each table once, in the layout its kernel
    reads.

    Triangles are in BVH-permuted order, padded to a multiple of 8 with
    degenerate triangles the intersector rejects.  The tables are in
    device memory; the root bounds and the scalars are on the host."""

    # (T, 12) f32: v0, e1, e2, face a triangle (ops/intersect.py; G7-G9).
    tri_records: torch.Tensor
    # (N, 8 or 12) i32: the binary BVH in DFS preorder with miss links
    # (ops/bvh.py), a record a node (ops/traversal.py; G7, G9).
    node_records: torch.Tensor
    # Per sub-block part, in part order: (nodes (Wp, 64) i32, octets
    # (Qp, 96) f32, remap (Qp*8,) i32 slot -> triangle), the layout K1
    # reads (ops/wide2.pack_k1); () when the scene exceeds the builder's
    # caps.
    k1_parts: tuple
    # (nodes (W, 64) i32, octets (G*8, 96) f32): the wide BVH in the
    # layout K3 reads (ops/wide_bvh.pack_k3); (0, 64) and (0, 96) when a
    # leaf is over MAX_LEAF_COUNT, and K3 refuses the scene.
    k3: tuple
    pl_remap: torch.Tensor  # (G*64,) i32 aligned slot -> triangle
    pw_max_stack: int  # per-ray stack bound of the wide tree
    max_leaf: int  # the binary BVH's largest leaf
    # Shading row per triangle: [n0.xyz, n1.xyz, emission, roughness,
    # n2.xyz, face.xyz, 0, 0, color.xyz, emission_color.xyz, 0, 0].
    sh_abc: torch.Tensor  # (T, 24) f32
    # The same rows per leaf slot across all sub-block parts (slot bases
    # accumulate in part order); (0, 24) without sub-block tables.
    sh_slot: torch.Tensor  # (S, 24) f32
    root_min: np.ndarray  # (3,) f32 scene AABB (the main BVH's node 0)
    root_max: np.ndarray  # (3,) f32

    @property
    def num_tris(self) -> int:
        return self.tri_records.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sh_abc.device


def scene_from_numpy(fields: dict, device) -> SceneData:
    """SceneData on ``device`` from NumPy arrays named as the JAX package's
    ``SceneData`` fields: the per-triangle ``v0/e1/e2/face``, the
    ``node_*`` BVH arrays, ``pw_tiles``, ``pw_entry``, ``pl_tri_tiles``,
    ``pl_remap``, the ``p2_*`` sub-block tables (``p2_extra`` a sequence of
    (node_rows, tri_rows, remap)), ``sh_abc`` and ``sh_slot``; other keys
    are ignored.  Each table is packed here into its kernel's layout and
    only that copy is uploaded: the records (intersect.pack_tri_records,
    traversal.pack_node_records), each part's K1 tables (wide2.pack_k1)
    and K3's (wide_bvh.pack_k3).  Span ``scene.upload``, ended once the
    device's copies have finished."""
    with profiling.Span("scene.upload"):
        data = _scene_from_numpy(fields, device)
        if data.device.type == "cuda":
            torch.cuda.synchronize(data.device)
    return data


def _scene_from_numpy(fields: dict, device) -> SceneData:
    def up(a, dtype):  # np.array copies: the sources may be read-only views
        return torch.from_numpy(np.array(a, dtype)).to(device)

    def host(names, dtype):  # the records are packed on the host
        return [torch.from_numpy(np.array(fields[k], dtype)) for k in names]

    node_min = np.asarray(fields["node_min"], np.float32)
    node_max = np.asarray(fields["node_max"], np.float32)
    parts = [(fields["p2_node_rows"], fields["p2_tri_rows"],
              fields["p2_remap"]), *fields["p2_extra"]]
    if np.shape(fields["p2_node_rows"])[0] == 0:
        parts = []  # over the builder's caps: no sub-block tables
    k1 = [(*pack_k1(np.asarray(n, np.float32), np.asarray(t, np.float32)), r)
          for n, t, r in parts]
    node_count = np.asarray(fields["node_count"])
    if node_count.max() > MAX_LEAF_COUNT:
        # K3's leaf entry cannot hold the leaf, and no path runs K3 on it
        # (renderer.resolve_traversal): empty tables, which K3 refuses
        k3 = (np.zeros((0, 64), np.int32), np.zeros((0, 96), np.float32))
    else:
        k3 = pack_k3(fields["pw_tiles"], fields["pl_tri_tiles"], node_count)
    return SceneData(
        tri_records=pack_tri_records(
            *host(("v0", "e1", "e2", "face"), np.float32)).to(device),
        node_records=pack_node_records(
            *host(("node_min", "node_max"), np.float32),
            *host(("node_miss", "node_first", "node_count"), np.int32)
        ).to(device),
        k1_parts=tuple((up(n, np.int32), up(o, np.float32), up(r, np.int32))
                       for n, o, r in k1),
        k3=(up(k3[0], np.int32), up(k3[1], np.float32)),
        pl_remap=up(fields["pl_remap"], np.int32),
        pw_max_stack=wide_max_stack(np.asarray(fields["pw_entry"])),
        max_leaf=int(node_count.max()) if node_count.size else 1,
        sh_abc=up(fields["sh_abc"], np.float32),
        sh_slot=up(fields["sh_slot"], np.float32),
        root_min=node_min[0].copy(),
        root_max=node_max[0].copy(),
    )


def torch_device(d) -> torch.device:
    """``d`` as a torch.device; a bare "cuda" names the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Scene:
    """Flatten scene objects and compile the device tables.

    API mirrors the reference (scene.py:9): ``Scene(objects)`` plus
    ``total_triangles`` (scene.py:135) and ``total_boxes`` (scene.py:219).
    ``build_bvh=False`` gives a single-leaf pseudo-BVH over every triangle,
    as in the JAX package; its leaf is too large for the BVH traversals,
    so the renderer runs such a scene by brute force.  ``verbose`` prints
    the reference's build banner, the BVH build's progress bar and the scene
    stats (scene.py:137-143, 238-245).
    """

    def __init__(self, objects: list, max_leaf_tris: int = 32,
                 build_bvh: bool = True, bvh_method: str = "sah",
                 verbose: bool = False):
        if not objects:
            raise ValueError("Scene requires at least one object")
        self.objects = objects
        self.max_leaf_tris = max_leaf_tris

        pos_list, norm_list, vertex_counts = [], [], []
        colors, emission_colors, surfaces = [], [], []
        for obj in objects:
            p = np.asarray(obj.pos, dtype=np.float32)
            pos_list.append(p)
            norm_list.append(np.asarray(obj.normals, dtype=np.float32))
            vertex_counts.append(p.shape[0])
            colors.append(np.asarray(obj.color, dtype=np.float32))
            emission_colors.append(
                np.asarray(obj.emission_color, dtype=np.float32))
            if obj.emission < 0:
                # emissive hits terminate paths (fragment.glsl:338-343);
                # negative emission would keep a path alive while adding
                # light, which the JAX package rejects too
                raise ValueError(
                    f"object {obj!r}: negative emission {obj.emission} is "
                    f"not supported (emissive hits must terminate paths)")
            surfaces.append([obj.emission, obj.roughness])

        pos = np.vstack(pos_list)
        normals = np.vstack(norm_list)
        n_tris = pos.shape[0] // 3
        if pos.shape[0] % 3 and verbose:
            print(f"Warning: {pos.shape[0] % 3} leftover vertex/vertices "
                  f"ignored when building triangles")

        # Consume vertices three at a time (scene.py:89-111).
        self.v0 = pos[0::3][:n_tris]
        self.v1 = pos[1::3][:n_tris]
        self.v2 = pos[2::3][:n_tris]
        self.n0 = normals[0::3][:n_tris]
        self.n1 = normals[1::3][:n_tris]
        self.n2 = normals[2::3][:n_tris]

        # Per-object material broadcast to per-triangle (scene.py:113-133).
        starts = np.concatenate(([0], np.cumsum(vertex_counts)))
        tri_start_vertices = np.arange(n_tris) * 3
        tri_obj_idx = np.searchsorted(starts, tri_start_vertices,
                                      side="right") - 1
        tri_obj_idx = np.clip(tri_obj_idx, 0, max(len(vertex_counts) - 1, 0))

        colors_arr = np.vstack(colors).astype(np.float32)
        emc_arr = np.vstack(emission_colors).astype(np.float32)
        surface_arr = np.vstack(surfaces).astype(np.float32)
        self.color = colors_arr[tri_obj_idx]
        self.emission_color = emc_arr[tri_obj_idx]
        self.emission = surface_arr[tri_obj_idx, 0]
        self.roughness = surface_arr[tri_obj_idx, 1]

        self.total_triangles = n_tris
        if n_tris == 0:
            raise ValueError("Scene has no triangles")
        self.bvh = None
        if build_bvh:
            if verbose:
                print("\nSlicing bounding boxes...")
            with profiling.Span("scene.bvh") as span:
                self.bvh = bvh_mod.build_bvh(self.v0, self.v1, self.v2,
                                             max_leaf_tris, method=bvh_method,
                                             progress=verbose)
                span.args = {"builder": bvh_mod.last_builder}
            if verbose:
                print(f"Time taken: {round(span.seconds, 2)} seconds")
        self.total_boxes = self.bvh.num_nodes if self.bvh is not None else 0
        if verbose:
            self._print_stats()
        self._fields: dict | None = None
        self._uploads: dict[torch.device, SceneData] = {}

    def _print_stats(self) -> None:
        """Scene stats, as the reference prints them after its upload
        (scene.py:238-245)."""
        print("\n---Scene---")
        print(f"Number of triangles: {self.total_triangles:,}")
        print(f"Number of vertices: {self.total_triangles * 3:,}")
        print(f"Number of objects: {len(self.objects)}")
        if self.bvh is not None:
            counts = self.bvh.node_count[self.bvh.node_count > 0]
            print(f"\nNumber of bounding boxes: {self.total_boxes:,}")
            print(f"Avg number of triangles per bounding box: "
                  f"{counts.mean():.1f}")
            print(f"Min number of triangles per bounding box: {counts.min()}")
            print(f"Max number of triangles per bounding box: {counts.max()}")

    def fields(self, pad_to: int = 8) -> dict:
        """The compiled tables as NumPy arrays (see scene_from_numpy);
        computed once, under the span ``scene.fields``."""
        if self._fields is None:
            with profiling.Span("scene.fields"):
                self._fields = self._compile(pad_to)
        return self._fields

    def _compile(self, pad_to: int) -> dict:
        T = self.total_triangles
        perm = (self.bvh.perm if self.bvh is not None
                else np.arange(T, dtype=np.int64))

        def permute_pad(arr: np.ndarray) -> np.ndarray:
            arr = arr[perm]
            n = arr.shape[0]
            Tp = max(((n + pad_to - 1) // pad_to) * pad_to, pad_to)
            if Tp != n:
                pad_shape = (Tp - n,) + arr.shape[1:]
                arr = np.concatenate([arr, np.zeros(pad_shape, arr.dtype)])
            return arr

        v0 = permute_pad(self.v0)
        v1 = permute_pad(self.v1)
        v2 = permute_pad(self.v2)
        e1 = v1 - v0
        e2 = v2 - v0
        face = np.cross(e1, e2)

        if self.bvh is not None:
            binary = self.bvh
        else:
            # Single-leaf pseudo-BVH over everything (scene.py:253-260).
            binary = bvh_mod.BVH(
                node_min=np.minimum(np.minimum(v0, v1), v2).min(
                    axis=0, keepdims=True),
                node_max=np.maximum(np.maximum(v0, v1), v2).max(
                    axis=0, keepdims=True),
                node_miss=np.array([1], np.int32),
                node_first=np.array([0], np.int32),
                node_count=np.array([T], np.int32),
                perm=perm, depth=0)
        node_count = binary.node_count

        tri16 = np.zeros((v0.shape[0], 16), np.float32)
        tri16[:, 0:3] = v0
        tri16[:, 3:6] = e1
        tri16[:, 6:9] = e2
        tri16[:, 9:12] = face

        # Octet-aligned triangle table of the wide-BVH kernel
        # (scene.py:264-301): each leaf's triangles copied to an 8-aligned
        # slot range, with the slack of one leaf's octets so the JAX
        # kernel's fixed-octet leaf read cannot run off the table (K3 reads
        # each leaf's own triangles only), in whole 64-triangle tiles;
        # slot s = g*64 + k*8 + j -> tile g, row j, lanes [k*16, k*16+16).
        tpr = TRIS_PER_OCTET
        leaf_octets_pad = -(-self.max_leaf_tris // tpr)
        leaf_ids = np.nonzero(node_count > 0)[0]
        counts = node_count[leaf_ids].astype(np.int64)
        offsets = np.concatenate(([0], np.cumsum(-(-counts // tpr) * tpr)))
        t_aligned = int(offsets[-1]) + leaf_octets_pad * tpr
        t_aligned = -(-t_aligned // 64) * 64

        leaf_first_octet = np.zeros(binary.num_nodes, np.int32)
        leaf_first_octet[leaf_ids] = (offsets[:-1] // tpr).astype(np.int32)
        pl_remap = np.zeros(t_aligned, np.int64)
        valid = np.zeros(t_aligned, bool)
        for off, first, cnt in zip(offsets[:-1], binary.node_first[leaf_ids],
                                   counts):
            pl_remap[off:off + cnt] = np.arange(first, first + cnt)
            valid[off:off + cnt] = True
        aligned16 = np.zeros((t_aligned, 16), np.float32)
        aligned16[valid] = tri16[pl_remap[valid]]
        pl_tri_tiles = (aligned16.reshape(t_aligned // 64, 8, 8, 16)
                        .transpose(0, 2, 1, 3)
                        .reshape(t_aligned // 64, 8, 128))
        wide = collapse_wide(binary, leaf_first_octet)

        # Sub-block tables: a separate leaf<=8 build over the FINAL
        # (permuted) triangles; remap lands directly in that index space.
        # Split at the card's budget, not the JAX package's on-chip one.
        with profiling.Span("scene.subblock", {"refused": False}) as span:
            try:
                parts = build_subblock_parts(
                    v0[:T], v1[:T], v2[:T], tri16[:T],
                    budget_bytes=CARD_TABLE_BUDGET_BYTES,
                    max_parts=CARD_MAX_PARTS, stats=span.args)
            except ValueError:
                parts = ()  # over the builder's caps: no sub-block tables
                span.args["refused"] = True
        if parts:
            p2 = (parts[0].node_rows, parts[0].tri_rows, parts[0].remap)
        else:
            p2 = (np.zeros((0, 128), np.float32),
                  np.zeros((0, 128), np.float32), np.zeros((0,), np.int32))

        Tp = v0.shape[0]
        sh_abc = np.zeros((Tp, 24), np.float32)
        sh_abc[:, 0:3] = permute_pad(self.n0)
        sh_abc[:, 3:6] = permute_pad(self.n1)
        sh_abc[:, 6] = permute_pad(self.emission)
        sh_abc[:, 7] = permute_pad(self.roughness)
        sh_abc[:, 8:11] = permute_pad(self.n2)
        sh_abc[:, 11:14] = face
        sh_abc[:, 16:19] = permute_pad(self.color)
        sh_abc[:, 19:22] = permute_pad(self.emission_color)
        if parts:
            sh_slot = np.concatenate(
                [sh_abc[np.clip(p.remap, 0, Tp - 1)] for p in parts])
        else:
            sh_slot = np.zeros((0, 24), np.float32)

        return dict(
            v0=v0, e1=e1, e2=e2, face=face,
            node_min=binary.node_min, node_max=binary.node_max,
            node_miss=binary.node_miss, node_first=binary.node_first,
            node_count=node_count,
            pw_tiles=wide.tiles, pw_entry=wide.entry,
            pl_tri_tiles=pl_tri_tiles, pl_remap=pl_remap.astype(np.int32),
            p2_node_rows=p2[0], p2_tri_rows=p2[1], p2_remap=p2[2],
            p2_extra=tuple((p.node_rows, p.tri_rows, p.remap)
                           for p in parts[1:]),
            sh_abc=sh_abc, sh_slot=sh_slot,
        )

    def send(self, device) -> SceneData:
        """Compile (once) and upload the scene to ``device`` (the
        reference's ``Scene.send`` SSBO upload, scene.py:145-236).  Each
        device's upload is kept and handed out again, as the JAX package's
        ``send`` keeps its one (``models/scene.py:223-224``), until
        :meth:`clearMemory`.  A bare "cuda" names the current card."""
        device = torch_device(device)
        data = self._uploads.get(device)
        if data is None:
            data = self._uploads[device] = scene_from_numpy(self.fields(),
                                                            device)
        return data

    def clearMemory(self) -> None:  # noqa: N802 (the reference's name)
        """Drop every device's upload (the reference's ``clearMemory``,
        scene.py:423): its tensors are freed once no renderer holds
        them; the next :meth:`send` uploads again."""
        self._uploads.clear()
