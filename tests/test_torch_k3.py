"""K3's Hopper layout and its walk, on the CPU, at small sizes.

* ``pack_k3``/``unpack_k3`` (ops/wide_bvh.py) give the wide tiles back bit
  for bit (empty slots' swapped boxes, padding groups and the triangle
  tiles' slack octets included) at max leaves of 8, 16 and 32, for the
  port's own scenes and for the JAX scene's tables carried over by
  ``scene_from_numpy``, and every leaf entry names its binary leaf's
  first octet and triangle count; tiles, octets and counts the layout
  cannot hold are refused; K1's tables are the bytes they were before
  K3's leaf entries took counts;
* a scalar NumPy walk over the Hopper tables in the kernel's way (a stack
  of node groups, the NaN slab test, empty slots closed by the order
  word's mask, each leaf's own triangles, a triangle's t before its
  barycentrics, one strict ``<`` per slot) finds the plain
  version's hits exactly and counts its five rows, on rays that lie in
  slab planes and face planes;
* the kernel's group column is picked from the tree's depth, and a tree
  deeper than the largest column is refused;
* a scene past the sub-block builder's caps renders under ``"auto"`` as
  ``"pallas"`` (K3);
* the plain versions of ``probes/k2.py``, the leaf accounting of
  ``probes/k3.py`` and the reference of its octet fetch.

Tolerance: exact everywhere (bit for bit); the walk repeats the plain
version's float32 operations in its order.
"""

import numpy as np
import pytest
import torch

from test_torch_traversal import (_cols, _fields, _jax_scene, _port_scene,
                                  _rays, _slab_plane_rays)

from opengl_raytracer_torch import (RenderConfig, Renderer, Triangles,
                                    make_camera)
from opengl_raytracer_torch.models import scene as scene_mod
from opengl_raytracer_torch.ops import pallas_traversal as wide
from opengl_raytracer_torch.ops.intersect import BIG
from opengl_raytracer_torch.ops import wide2
from opengl_raytracer_torch.ops.wide_bvh import (EMPTY_ENTRY, EMPTY_PACKED,
                                                 MAX_LEAF_COUNT, PACK_LIMIT,
                                                 decode_k3_leaf, leaf_counts,
                                                 pack_k3, stack_bound,
                                                 unpack_k3, wide_depth)
from opengl_raytracer_torch.probes import k2 as k2_probe
from opengl_raytracer_torch.probes import k3 as k3_probe
from test_torch_scene import field_parts
from test_torch_scene import jax_native  # noqa: F401 (autouse)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _assert_round_trip(fields, data):
    """``data.k3`` decodes to the tiles of ``fields`` (``Scene.fields()``
    or a JAX SceneData's) bit for bit."""
    nodes, octets = (x.numpy() for x in data.k3)
    assert nodes.dtype == np.int32 and nodes.shape[1] == 64
    assert octets.dtype == np.float32 and octets.shape[1] == 96
    assert octets.shape[0] == fields["pl_tri_tiles"].shape[0] * 8
    pw, pl = unpack_k3(nodes, octets)
    np.testing.assert_array_equal(_bits(pw), _bits(fields["pw_tiles"]))
    np.testing.assert_array_equal(_bits(pl), _bits(fields["pl_tri_tiles"]))
    word = nodes[:, 56:].astype(np.int64) & 0xFFFFFFFF
    slots = (word[:, :, None] >> (3 * np.arange(8))) & 7
    assert (np.sort(slots, axis=2) == np.arange(8)).all()
    entry = fields["pw_entry"]  # the tiles' entries, slot order
    full = entry != EMPTY_ENTRY
    assert (word >> 24 == ((full.astype(np.int64) << np.arange(8))
                           .sum(axis=1))[:, None]).all()  # non-empty slots
    # each leaf entry: its binary leaf's first octet and count, every leaf
    # once, as Scene.fields lays the leaves out
    ents = nodes[:, 48:56].astype(np.int64)
    assert (ents[full & (entry >= 0)] == entry[full & (entry >= 0)]).all()
    leaf = full & (entry < 0)
    first, count = decode_k3_leaf(ents[leaf])
    assert (first == -entry[leaf].astype(np.int64) - 1).all()
    counts = np.asarray(fields["node_count"]).astype(np.int64)
    counts = counts[counts > 0]
    firsts = np.concatenate(([0], np.cumsum(-(-counts // 8))))[:-1]
    order = np.argsort(first)
    np.testing.assert_array_equal(first[order], firsts)
    np.testing.assert_array_equal(count[order], counts)
    return nodes


@pytest.mark.parametrize("leaf", [8, 16, 32])
def test_k3_tables_round_trip(leaf):
    """The port's own scene: the Hopper tables decode to its tiles bit for
    bit, the tree has empty slots and padding groups, and only the real
    nodes are kept."""
    scene = _port_scene(300, leaf=leaf)
    fields = scene.fields()
    nodes = _assert_round_trip(fields, scene.send("cpu"))
    assert (nodes[:, 48:56] == EMPTY_PACKED).any()  # empty slots
    W = nodes.shape[0]
    assert W == fields["pw_entry"].shape[0]
    assert fields["pw_tiles"].shape[0] * 8 >= W


@pytest.mark.parametrize("leaf", [8, 16, 32])
def test_k3_tables_from_jax_scene(leaf):
    """The JAX scene's tiles, carried over by scene_from_numpy, pack to the
    same Hopper tables as the port's own Scene of the same objects, and
    decode back to the JAX tiles."""
    jdata, tdata = _jax_scene(300, leaf=leaf)
    _assert_round_trip(_fields(jdata), tdata)
    port = _port_scene(300, leaf=leaf).send("cpu")
    for a, b in zip(tdata.k3, port.k3):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _moved_leaf(pw, entry, new_first):
    """The tiles with one leaf entry's first octet moved to ``new_first``
    in every octant's order lanes."""
    leaf = (entry < 0) & (entry != EMPTY_ENTRY)
    w, j = (int(x[0]) for x in np.nonzero(leaf))
    bad = pw.copy()
    lanes = bad[w // 8, :, (w % 8) * 16 + 6:(w % 8) * 16 + 14]
    packed = lanes.astype(np.int64)
    hit = packed == int(entry[w, j]) * 8 + j
    assert hit.sum() == 8  # one rank in each octant
    lanes[hit] = np.float32((-new_first - 1) * 8 + j)
    return bad


def test_k3_pack_refuses_what_it_cannot_hold():
    """Non-zero pad lanes, a padding group between nodes and order lanes
    that name a slot twice are refused; so are a leaf entry at an octet
    where no leaf starts, an octet past the leaf entry's budget and a leaf
    of more triangles than it can count (a build_bvh=False scene, whose
    K3 tables are left empty)."""
    fields = _port_scene(300, leaf=16).fields()
    pw, pl = fields["pw_tiles"], fields["pl_tri_tiles"]
    count = fields["node_count"]
    bad = pw.copy()
    bad[0, 0, 15] = 1.0  # node 0's pad lane
    with pytest.raises(ValueError, match="pad lanes"):
        pack_k3(bad, pl, count)
    bad = pl.copy()
    bad[0, 0, 13] = -0.0  # a triangle's pad lane, as bits
    with pytest.raises(ValueError, match="pad lanes"):
        pack_k3(pw, bad, count)
    bad = pw.copy()
    bad[0, :, 16 + 6:16 + 14] = 0.0  # node 1's order lanes: a padding group
    with pytest.raises(ValueError, match="padding groups"):
        pack_k3(bad, pl, count)
    bad = pw.copy()
    lanes = bad[0, :, 6]  # node 0, octant 0: one slot named twice
    live = lanes != EMPTY_PACKED * 8
    lanes[np.nonzero(live)[0][1]] = lanes[np.nonzero(live)[0][0]]
    with pytest.raises(ValueError):
        pack_k3(bad, pl, count)
    entry = fields["pw_entry"]
    inner = int(np.nonzero(leaf_counts(count, pl.shape[0] * 8) == 0)[0][0])
    with pytest.raises(ValueError, match="no leaf starts"):
        pack_k3(_moved_leaf(pw, entry, inner), pl, count)
    with pytest.raises(ValueError, match="does not fit K3's leaf entry"):
        pack_k3(_moved_leaf(pw, entry, PACK_LIMIT - 1), pl, count)
    g = np.random.default_rng(4)
    tris = g.uniform(-1, 1, (MAX_LEAF_COUNT + 1, 3, 3)).astype(np.float32)
    flat = scene_mod.Scene([Triangles(tris)], build_bvh=False)
    fdata, ffields = flat.send("cpu"), flat.fields()
    assert fdata.max_leaf == MAX_LEAF_COUNT + 1
    assert fdata.k3[0].shape == (0, 64) and fdata.k3[1].shape == (0, 96)
    with pytest.raises(ValueError, match=f"leaf of {MAX_LEAF_COUNT + 1} "):
        pack_k3(ffields["pw_tiles"], ffields["pl_tri_tiles"],
                ffields["node_count"])


def _grid_triangles(n=601):
    """Triangles on an integer grid whose centroids are integers, distinct
    on every axis: every sum, mean and sort of a NumPy build is exact."""
    i = np.arange(n, dtype=np.int64)
    p = np.stack([i, (i * 37) % n, (i * 101) % n], axis=1)
    a = np.stack([(i % 5) + 1, (i % 3), -(i % 7) - 1], axis=1)
    b = np.stack([-(i % 4), (i % 6) + 1, (i % 2) + 1], axis=1)
    return tuple(x.astype(np.float32) for x in (p + a, p + b, p - a - b))


# SHA-256 of pack_k1's (nodes, octets) bytes over _grid_triangles' sub-block
# tables, recorded before K3's leaf entries took their counts.
K1_GRID_SHA256 = ("ae434c384004d14fd3c76d1a269f3480"
                  "6de7c2357a54f32bc1cda3804c783252")


def test_k1_tables_unchanged_by_k3_counts(monkeypatch):
    """K1's tables (ops/wide2.pack_k1, which shares pack_nodes with
    pack_k3) are byte-equal to what they were before K3's leaf entries
    took counts: the digest of a NumPy build recorded then; a scene's K1
    tables are pack_k1 of its rows, and packing its K3 tables leaves them
    as they are."""
    import hashlib

    build = wide2.build_bvh
    monkeypatch.setattr(wide2, "build_bvh",
                        lambda *a, **k: build(*a, prefer_native=False, **k))
    v0, v1, v2 = _grid_triangles()
    tri16 = np.zeros((v0.shape[0], 16), np.float32)
    e1, e2 = v1 - v0, v2 - v0
    tri16[:, 0:3], tri16[:, 3:6], tri16[:, 6:9] = v0, e1, e2
    tri16[:, 9:12] = np.cross(e1, e2)
    t = wide2.build_subblock(v0, v1, v2, tri16)
    nodes, octets = wide2.pack_k1(t.node_rows, t.tri_rows)
    digest = hashlib.sha256(nodes.tobytes() + octets.tobytes()).hexdigest()
    assert digest == K1_GRID_SHA256
    scene = _port_scene(300, leaf=32)
    data, fields = scene.send("cpu"), scene.fields()
    rows = field_parts(fields)[0][:2]
    before = wide2.pack_k1(*rows)
    pack_k3(fields["pw_tiles"], fields["pl_tri_tiles"], fields["node_count"])
    after = wide2.pack_k1(*rows)
    for a, b, c in zip(before, after, data.k1_parts[0][:2]):
        assert a.tobytes() == b.tobytes() == c.numpy().tobytes()


def _k3_walk(nodes, octets, o, d, t0, entries=None):
    """One ray's walk as csrc/wide_traversal.cu does it, in NumPy float32
    scalars over the Hopper tables: a stack of node groups (a node and the
    mask of its children still to visit, by near-first rank in the ray's
    octant), each child opened at its parent's visit by the slab test with
    the unclamped inverse (closed on a NaN slab value) and ``max(near, 0)
    <= best_t``; a leaf's own triangles, first octet and count decoded
    from its entry; per triangle, t first and the barycentrics only when t
    beats the running best.  Returns (t, slot, u, v, node visits, leaf
    entries, triangles whose t beat the best, octets tested, triangles
    tested); each leaf entry adds 1 to ``entries`` at its first octet."""
    f32 = np.float32
    bt, slot, bu, bv = f32(t0), 0, f32(0), f32(0)
    if not bt > -BIG:
        return bt, slot, bu, bv, 0, 0, 0, 0, 0
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        inv = [f32(1) / d[a] for a in range(3)]
        return _walk(nodes, octets, o, d, inv, bt, slot, bu, bv, entries)


def _walk(nodes, octets, o, d, inv, bt, slot, bu, bv, entries):
    f32 = np.float32
    eps = f32(1e-6)
    octant = (int(d[0] < 0) << 2) | (int(d[1] < 0) << 1) | int(d[2] < 0)
    boxes = np.ascontiguousarray(nodes[:, :48]).view(np.float32)
    octets = octets.reshape(-1, 12)  # one row a slot
    groups, cur, visits, leaves, cands, n_oct, n_slots = [], 0, 0, 0, 0, 0, 0
    while True:
        if cur >= 0:
            visits += 1
            b = boxes[cur].reshape(6, 8)
            hit = 0
            for j in range(8):
                t1 = [(b[a, j] - o[a]) * inv[a] for a in range(3)]
                t2 = [(b[3 + a, j] - o[a]) * inv[a] for a in range(3)]
                if any(np.isnan(x) for x in t1 + t2):
                    continue  # a NaN slab keeps the child closed
                near = max(max(min(t1[0], t2[0]), min(t1[1], t2[1])),
                           min(t1[2], t2[2]))
                far = min(min(max(t1[0], t2[0]), max(t1[1], t2[1])),
                          max(t1[2], t2[2]))
                if far >= near and far >= 0 and max(near, f32(0)) <= bt:
                    hit |= 1 << j
            word = int(nodes[cur, 56 + octant]) & 0xFFFFFFFF
            hit &= word >> 24  # the non-empty slots
            mask = sum(1 << r for r in range(8)
                       if hit >> ((word >> (3 * r)) & 7) & 1)
            if mask:
                groups.append((cur, mask))
        else:
            leaves += 1
            first, n = (int(x) for x in decode_k3_leaf(cur))
            n_oct, n_slots = n_oct + -(-n // 8), n_slots + n
            if entries is not None:
                entries[first] += 1
            for s in range(first * 8, first * 8 + n):
                c = octets[s]
                v0, fc, e1, e2 = c[0:3], c[3:6], c[6:9], c[9:12]
                det = d[0] * fc[0] + d[1] * fc[1] + d[2] * fc[2]
                if not abs(det) >= eps:
                    continue
                inv_det = f32(1) / det
                r = [o[a] - v0[a] for a in range(3)]
                t = -(r[0] * fc[0] + r[1] * fc[1] + r[2] * fc[2]) * inv_det
                if not (t > eps and t < bt):
                    continue
                cands += 1
                p = [r[1] * d[2] - r[2] * d[1], r[2] * d[0] - r[0] * d[2],
                     r[0] * d[1] - r[1] * d[0]]
                u = -(e2[0] * p[0] + e2[1] * p[1] + e2[2] * p[2]) * inv_det
                v = (e1[0] * p[0] + e1[1] * p[1] + e1[2] * p[2]) * inv_det
                if u >= 0 and v >= 0 and u + v <= 1:
                    bt, slot, bu, bv = t, s, u, v
        if not groups:
            return (bt, slot, bu, bv, visits, leaves, cands, n_oct,
                    n_slots)
        w, mask = groups.pop()
        rank = (mask & -mask).bit_length() - 1
        cur = int(nodes[w, 48 + ((int(nodes[w, 56 + octant]) >> (3 * rank))
                                 & 7)])
        if mask & (mask - 1):
            groups.append((w, mask & (mask - 1)))


def _walk_rays(fields, R, seed):
    """Random rays with axis-parallel rays whose origins lie on the root's
    children's slab planes (4-15) and, as in
    test_k3_face_plane_rays_follow_per_ray_slab_test, one ray in a face
    plane of the scene's box and one just off it (0-1)."""
    o, d = _rays(R, seed=seed)
    _slab_plane_rays(fields, o, d)
    lo0 = fields["node_min"][0]
    o[:, :2] = np.asarray([[0.0, lo0[1], lo0[2] - 1.0],
                           [0.0, lo0[1] + np.float32(1e-3), lo0[2] - 1.0]],
                          np.float32).T
    d[:, :2] = np.asarray([[0.0, 0.0, 1.0]] * 2, np.float32).T
    return o, d


@pytest.mark.parametrize("leaf", [8, 32])
def test_k3_scalar_walk_matches_plain(leaf):
    """The kernel's walk as scalar NumPy over the Hopper tables gives the
    plain version's t, slot, u and v bit for bit, and its visits, leaf
    entries, candidate triangles, octets and triangles tested, ray by
    ray."""
    scene = _port_scene(800, leaf=leaf)
    data = scene.send("cpu")
    R = 40
    o, d = _walk_rays(scene.fields(), R, seed=21)
    t0 = np.full(R, BIG, np.float32)
    t0[[17, 29]] = -BIG  # dead rays
    t0[33] = np.float32(2.5)  # an entry t: prunes against it
    *got, dropped, counts = wide._traverse_plain(
        *data.k3, _cols(o), _cols(d), torch.from_numpy(t0),
        wide.stack_size(data.pw_max_stack), counts=True)
    assert int(dropped) == 0 and counts.shape == (5, R)
    nodes, octets = (x.numpy() for x in data.k3)
    for r in range(R):
        t, slot, u, v, *work = _k3_walk(nodes, octets, o[:, r], d[:, r],
                                        t0[r])
        assert tuple(int(c) for c in counts[:, r]) == tuple(work), r
        assert (float(got[0][r]), int(got[1][r]), float(got[2][r]),
                float(got[3][r])) == (float(t), slot, float(u), float(v)), r
    assert float(got[0][0]) == BIG and float(got[0][1]) < BIG
    assert int(counts[0].max()) > 2 and int(counts[1].sum()) > R
    assert int(counts[2].sum()) > int((got[0] < BIG).sum())
    # exact leaves: fewer triangles than whole octets where a leaf is short
    assert int(counts[4].sum()) < 8 * int(counts[3].sum())


def test_k3_counting_leaves_hits_unchanged():
    """Counting does not change the plain version's results."""
    data = _port_scene(400, leaf=16).send("cpu")
    o, d = _rays(256, seed=22)
    args = (*data.k3, _cols(o), _cols(d), torch.full((256,), BIG),
            wide.stack_size(data.pw_max_stack))
    plain = wide._traverse_plain(*args)
    counted = wide._traverse_plain(*args, counts=True)
    assert len(counted) == 6
    for a, b in zip(plain, counted[:5]):
        assert torch.equal(a, b)


def test_k3_group_column_from_depth():
    """The column holds max_depth + 1 groups: 16 up to depth 15, 71 up to
    the builder's deepest tree (depth 70, the 512-entry stack bound); a
    deeper tree is refused."""
    for depth in range(0, 72):
        assert wide_depth(stack_bound(depth)) == depth
        if depth <= 15:
            assert wide.group_column(stack_bound(depth)) == 16
        elif depth <= 70:
            assert wide.group_column(stack_bound(depth)) == 71
        else:
            with pytest.raises(ValueError, match="node groups"):
                wide.group_column(stack_bound(depth))
    assert stack_bound(70) <= 512 < stack_bound(71)


def test_auto_runs_k3_past_subblock_caps(monkeypatch):
    """A scene whose sub-block build raises keeps no sub-block tables;
    "auto" then resolves to "pallas" and renders as traversal="pallas"
    does, bit for bit."""
    def over_caps(*a, **k):
        raise ValueError("part tables over budget")

    monkeypatch.setattr(scene_mod, "build_subblock_parts", over_caps)
    scene = _port_scene(400, leaf=32)
    data = scene.send("cpu")
    assert len(data.k1_parts) == 0 and data.sh_slot.shape[0] == 0
    cam = make_camera([0.0, 0.0, -14.0], (0.0, 0.0))
    imgs = []
    for traversal in ("auto", "pallas"):
        r = Renderer(data, RenderConfig(width=24, height=16, bounces=2,
                                        traversal=traversal), device="cpu")
        assert r.traversal == "pallas"
        imgs.append(r.image(r.render(cam, frames=2)))
    assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0.01
    np.testing.assert_array_equal(imgs[0], imgs[1])


def test_k3_own_share_reads_only_own_leaves():
    """The probe's leaf accounting, from leaf entries counted by first
    octet as the scalar walk enters them and the octets and triangles it
    tests: every octet and triangle tested is the entered leaf's own
    (share 1.0), and short leaves test fewer than whole octets; an entry
    where no leaf starts is refused."""
    scene = _port_scene(600, leaf=32)
    data, fields = scene.send("cpu"), scene.fields()
    nodes, octets = (x.numpy() for x in data.k3)
    Q = octets.shape[0]
    o, d = _walk_rays(fields, 48, seed=23)
    hist = np.zeros(Q, np.int64)
    tested = np.zeros(2, np.int64)  # octets, triangles
    for r in range(o.shape[1]):
        work = _k3_walk(nodes, octets, o[:, r], d[:, r], BIG, hist)[4:]
        tested += work[3:]
    stages = dict(octets=int(tested[0]), slots=int(tested[1]))
    share = k3_probe.own_share(data, torch.from_numpy(hist), stages)
    assert share["entries"] == int(hist.sum()) > 48
    assert share["octets"] == share["own_octets"] == stages["octets"]
    assert share["slots"] == share["own_slots"] == stages["slots"]
    assert share["own_share"] == share["own_slot_share"] == 1.0
    assert share["slots_per_entry"] < 8 * share["octets_per_entry"] <= 32
    stages["octets"] += 1  # a neighbour's octet read
    assert k3_probe.own_share(data, torch.from_numpy(hist),
                              stages)["own_share"] < 1.0
    counts = leaf_counts(fields["node_count"], Q)
    hist[int(np.nonzero(counts == 0)[0][0])] = 1
    with pytest.raises(RuntimeError, match="no leaf starts"):
        k3_probe.own_share(data, torch.from_numpy(hist), stages)


def test_k3_tile_octets_are_the_tables_octets():
    """The octet fetch's reference, ``unpack_octets`` of K3's octet rows,
    is the tiles' octets (``Scene.fields()``): octet q is tile q // 8, its
    8 rows, lanes ``(q % 8) * 16 .. + 16``."""
    scene = _port_scene(300, leaf=16)
    data, pl = scene.send("cpu"), scene.fields()["pl_tri_tiles"]
    Q = data.k3[1].shape[0]
    idx = [0, 1, 7, 8, 9, Q - 1]
    ref = wide2.unpack_octets(data.k3[1].numpy()[idx])
    tiles = np.stack([pl[q // 8, :, (q % 8) * 16:(q % 8) * 16 + 16]
                      for q in idx])
    np.testing.assert_array_equal(_bits(tiles), _bits(ref))
    octs = data.k3[1].numpy()[idx].reshape(-1, 8, 12)
    np.testing.assert_array_equal(_bits(tiles[:, :, 0:3]),
                                  _bits(octs[:, :, 0:3]))  # v0
    np.testing.assert_array_equal(_bits(tiles[:, :, 9:12]),
                                  _bits(octs[:, :, 3:6]))  # face


def test_k2_probe_plain_matches_numpy_sum():
    """probes/k2.py's plain version (both sums, on CPU tensors) against a
    NumPy float32 sum in the same order, bit for bit, at the probe's
    slot pattern (sorted, jittered by +-3)."""
    table, table_t, slots = k2_probe.probe_inputs(5, R=20_000, S=3_033)
    s = slots.numpy()
    assert (np.diff(s) >= -6).all() and s.min() >= 0 and s.max() < 3_033
    rows = table.numpy()[s]
    acc = rows[:, 0].copy()
    for a in range(1, 24):
        acc = (acc + rows[:, a] * np.float32(1 + a)).astype(np.float32)
    for got in (k2_probe.rows_sum(table, slots),
                k2_probe.cols_sum(table_t, slots)):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      acc.view(np.int32))
    assert k2_probe.bytes_moved(20_000, 3_033) == 3_033 * 96 + 20_000 * 8
    with pytest.raises(ValueError, match="table must be"):
        k2_probe.rows_sum(table_t, slots)
