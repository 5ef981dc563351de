"""Scene compiler: scene-graph objects -> the device tables the renderer reads.

Flattening, the per-object material broadcast and the BVH permutation
follow ``opengl_raytracer_tpu/models/scene.py`` line for line (reference:
scene.py:9-236), so both packages build bit-identical tables from the same
objects.  :meth:`Scene.send` uploads only what this package's traversal
and shading read: the sub-block parts (ops/wide2.py), the slot-order
material table ``sh_slot`` and the scene's root bounds.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opengl_raytracer_torch.ops import bvh as bvh_mod
from opengl_raytracer_torch.ops.wide2 import build_subblock_parts


class SceneData(NamedTuple):
    """Device-resident scene.

    The sub-block tables are in device memory; the root bounds are small
    host arrays the sort keys read as scalars."""

    p2_node_rows: torch.Tensor  # (Wp, 128) f32: wide nodes, one per row
    p2_tri_rows: torch.Tensor  # (Qp, 128) f32: leaf octets, one per row
    p2_remap: torch.Tensor  # (Qp*8,) i32: slot -> triangle (scene order)
    p2_extra: tuple  # further parts' (node_rows, tri_rows, remap)
    # Shading row per leaf slot across all parts (slot bases accumulate in
    # part order): [n0.xyz, n1.xyz, emission, roughness, n2.xyz, face.xyz,
    # 0, 0, color.xyz, emission_color.xyz, 0, 0].
    sh_slot: torch.Tensor  # (S, 24) f32
    root_min: np.ndarray  # (3,) f32 scene AABB (the main BVH's node 0)
    root_max: np.ndarray  # (3,) f32

    @property
    def parts(self) -> tuple:
        return ((self.p2_node_rows, self.p2_tri_rows, self.p2_remap),
                *self.p2_extra)

    @property
    def device(self) -> torch.device:
        return self.sh_slot.device


def scene_from_numpy(fields: dict, device) -> SceneData:
    """SceneData on ``device`` from NumPy arrays named as the JAX package's
    ``SceneData`` fields: ``p2_node_rows``, ``p2_tri_rows``, ``p2_remap``,
    ``p2_extra`` (a sequence of (node_rows, tri_rows, remap)), ``sh_slot``,
    ``node_min`` and ``node_max``; other keys are ignored."""

    def up(a):  # np.array copies: the sources may be read-only views
        return torch.from_numpy(np.array(a)).to(device)

    return SceneData(
        p2_node_rows=up(np.asarray(fields["p2_node_rows"], np.float32)),
        p2_tri_rows=up(np.asarray(fields["p2_tri_rows"], np.float32)),
        p2_remap=up(np.asarray(fields["p2_remap"], np.int32)),
        p2_extra=tuple(
            (up(np.asarray(n, np.float32)), up(np.asarray(t, np.float32)),
             up(np.asarray(r, np.int32)))
            for n, t, r in fields["p2_extra"]),
        sh_slot=up(np.asarray(fields["sh_slot"], np.float32)),
        root_min=np.asarray(fields["node_min"], np.float32)[0].copy(),
        root_max=np.asarray(fields["node_max"], np.float32)[0].copy(),
    )


class Scene:
    """Flatten scene objects and compile the device tables.

    API mirrors the reference (scene.py:9): ``Scene(objects)`` plus
    ``total_triangles`` (scene.py:135) and ``total_boxes`` (scene.py:219).
    """

    def __init__(self, objects: list, max_leaf_tris: int = 32,
                 bvh_method: str = "sah"):
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
        self.bvh = bvh_mod.build_bvh(self.v0, self.v1, self.v2,
                                     max_leaf_tris, method=bvh_method)
        self.total_boxes = self.bvh.num_nodes
        self._fields: dict | None = None

    def fields(self, pad_to: int = 8) -> dict:
        """The compiled tables as NumPy arrays (see scene_from_numpy);
        computed once."""
        if self._fields is not None:
            return self._fields
        perm = self.bvh.perm

        def permute_pad(arr: np.ndarray) -> np.ndarray:
            arr = arr[perm]
            T = arr.shape[0]
            Tp = max(((T + pad_to - 1) // pad_to) * pad_to, pad_to)
            if Tp != T:
                pad_shape = (Tp - T,) + arr.shape[1:]
                arr = np.concatenate([arr, np.zeros(pad_shape, arr.dtype)])
            return arr

        v0 = permute_pad(self.v0)
        v1 = permute_pad(self.v1)
        v2 = permute_pad(self.v2)
        e1 = v1 - v0
        e2 = v2 - v0
        face = np.cross(e1, e2)

        tri16 = np.zeros((v0.shape[0], 16), np.float32)
        tri16[:, 0:3] = v0
        tri16[:, 3:6] = e1
        tri16[:, 6:9] = e2
        tri16[:, 9:12] = face

        # Sub-block tables: a separate leaf<=8 build over the FINAL
        # (permuted) triangles; remap lands directly in that index space.
        T = self.total_triangles
        try:
            parts = build_subblock_parts(v0[:T], v1[:T], v2[:T], tri16[:T])
        except ValueError:
            parts = ()  # over the builder's caps: no sub-block tables
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

        self._fields = dict(
            p2_node_rows=p2[0], p2_tri_rows=p2[1], p2_remap=p2[2],
            p2_extra=tuple((p.node_rows, p.tri_rows, p.remap)
                           for p in parts[1:]),
            sh_slot=sh_slot,
            node_min=self.bvh.node_min, node_max=self.bvh.node_max,
        )
        return self._fields

    def send(self, device) -> SceneData:
        """Compile (once) and upload the scene to ``device`` (the
        reference's ``Scene.send`` SSBO upload, scene.py:145-236)."""
        return scene_from_numpy(self.fields(), device)
