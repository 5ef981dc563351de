"""The port's CUDA kernels against their plain torch versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA card and
skips without one.  On a machine with a card (and without JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which configures JAX.)

Tolerances: the kernels round every float operation to nearest in the
plain versions' order (no mul+add contraction), so they are expected to
agree bit for bit; K1 (the whole part chain in one launch, of one
part or several), K3, the probes and the glue kernels G1-G9 but G4 (ray
front, int32 sort keys, reorder and restore, K3's
prologue and epilogue, the band fold, the "bvh" walk, the brute-force
sweep, the packet walk; G1 and G6 also in the packet traversal's 8x16
block order) and the step block's write are held to that, the shade floats to ``rtol=1e-5,
atol=1e-6`` as the CPU tests against the JAX package do, with seeds and
alive flags exact.  The compiled step: replayed CUDA graphs equal the
eager body bit for bit (every traversal name, remainder tiles,
frames_per_step 2 with rays_per_pixel 2, a (2, 2) mesh of the one card,
the reorder cadence ``sort_every=2``), through camera moves, resets,
lambertian toggles and sky changes, and with each step's block written
ahead by the step before it; frames at cadences 1, 2 and 4 are equal bit
for bit.  ``device_sync``, its read queued before its wait, returns the
old read's value bit for bit.
"""

import numpy as np
import pytest
import torch

from opengl_raytracer_torch import (Rect, RenderConfig, Renderer, Scene,
                                    Triangles, make_camera)
from opengl_raytracer_torch.models import scene as scene_mod
from opengl_raytracer_torch.ops import _kernels, shade
from opengl_raytracer_torch.ops import pallas_traversal as wide
from opengl_raytracer_torch.ops import subblock_traversal as sbt
from opengl_raytracer_torch.ops.intersect import BIG, Nearest
from opengl_raytracer_torch.ops.wide2 import unpack_octets
from opengl_raytracer_torch.renderer import effective_max_leaf
from opengl_raytracer_torch.utils.image import rmse
from torch_states import (SORT_KINDS, box_objects, recon_states,
                          sort_keys_case)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _objects(n_tris=400):
    g = np.random.default_rng(0)
    tris = g.uniform(-3, 3, (n_tris, 3, 3)).astype(np.float32)
    return [
        Triangles(tris, color=(0.3, 0.3, 0.9), roughness=0.5),
        Rect([10, 10, 10], [0, 0, 0], [0, 0, 0], [0.8, 0.8, 0.8],
             roughness=1),
        Rect([1.5, 1.5, 0.1], [0, 4.5, 0], [90, 0, 0], [0, 0, 0], [1, 1, 1],
             1.5, roughness=1),
    ]


def _rays(R, device, seed=1):
    g = np.random.default_rng(seed)
    o = g.uniform(-4.5, 4.5, (3, R)).astype(np.float32)
    d = g.normal(size=(3, R))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    d = d.astype(np.float32)
    d[:, :3] = np.eye(3, dtype=np.float32)  # axis-parallel: clamped inverses
    t0 = np.full(R, BIG, np.float32)
    t0[g.uniform(size=R) < 0.1] = -BIG  # dead rays
    return (tuple(torch.from_numpy(o[a].copy()).to(device) for a in range(3)),
            tuple(torch.from_numpy(d[a].copy()).to(device) for a in range(3)),
            torch.from_numpy(t0).to(device))


def _k1_matches_plain(data, o3, d3, t0):
    """K1's chain kernel against its plain version (``_chain_plain``) over
    the same tables, bit for bit in all five columns: on each part of
    ``data`` alone and, past one part, on the whole chain, one launch
    walking its parts each time.  Returns the hit count of the last
    chain."""
    ov = sbt.overflow_tensor(t0.device)
    chains = [(part,) for part in data.k1_parts]
    if len(chains) > 1:
        chains.append(data.k1_parts)
    for parts in chains:
        ov.zero_()
        before = dict(_kernels.launch_counts)
        got = sbt.traverse_parts(data._replace(k1_parts=parts), o3, d3, t0)
        assert {k: n - before[k] for k, n in _kernels.launch_counts.items()
                if n != before[k]} == {"subblock_traversal": 1,
                                       "subblock_parts": len(parts)}
        ref, dropped = sbt._chain_plain(parts, o3, d3, t0)
        torch.cuda.synchronize()
        assert int(ov.item()) == 0 and int(dropped) == 0
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        dead = t0 <= -BIG  # dead rays accept nothing: a miss at slot 0
        assert (got.t[dead] == BIG).all() and (got.slot[dead] == 0).all()
    return int((ref.t < BIG).sum())


def test_traverse_kernel_matches_plain(cuda):
    data = Scene(_objects(), max_leaf_tris=16).send(cuda)
    o3, d3, t0 = _rays(3000, cuda)  # not a multiple of the block size
    assert _k1_matches_plain(data, o3, d3, t0) > 1000


def test_traverse_kernel_matches_plain_multi_part(cuda, monkeypatch):
    """Each part of a scene split into several, and the whole chain, with
    the entry t of a later part (prunes against it)."""
    orig = scene_mod.build_subblock_parts
    monkeypatch.setattr(scene_mod, "build_subblock_parts",
                        lambda *a, **k: orig(*a, budget_bytes=64 * 1024))
    data = Scene(_objects(1200), max_leaf_tris=16).send(cuda)
    assert len(data.k1_parts) > 1
    o3, d3, t0 = _rays(4096, cuda, seed=5)
    t0 = torch.where(torch.arange(4096, device=cuda) % 3 == 0,
                     torch.full_like(t0, 3.0), t0)
    assert _k1_matches_plain(data, o3, d3, t0) > 1000


def test_k1_profile_matches_kernel(cuda):
    """The profile build (probes/k1.py), the kernel's walk of one part,
    finds the plain walk's raw hits (t, slot, u, v), counts its visits,
    octets and barycentric tests, and counts its launches apart from the
    kernel's."""
    from opengl_raytracer_torch.probes import k1 as k1_probe

    data = Scene(_objects(), max_leaf_tris=16).send(cuda)
    k1 = data.k1_parts[0]
    o3, d3, t0 = _rays(3000, cuda, seed=6)
    before = dict(_kernels.launch_counts)
    hits, stages = k1_probe.profile(k1, o3, d3, t0)
    assert _kernels.launch_counts["k1_profile"] == before["k1_profile"] + 1
    assert (_kernels.launch_counts["subblock_traversal"]
            == before["subblock_traversal"])
    *plain, _, counts = sbt._traverse_plain(*k1[:2], o3, d3, t0,
                                            counts=True)
    for a, b in zip(hits, plain):
        assert torch.equal(a, b)
    counts = counts.long()
    assert stages["visits"] == int(counts[0].sum())
    assert stages["octets"] == int(counts[1].sum())
    assert stages["edge_loads"] == int(counts[3].sum())
    assert all(stages[s] > 0 for s in k1_probe.STAGES)


def _face_plane_rays(data, o3, d3, t0):
    """Rays 3-5 lie in face planes of the scene's bounding box: their slab
    tests meet 0 * inf = NaN, which both versions keep closed."""
    lo = data.root_min
    for r, a in ((3, 0), (4, 1), (5, 2)):
        b = (a + 1) % 3
        for k in range(3):
            o3[k][r] = float(lo[k]) + 1.0
            d3[k][r] = 0.0
        o3[a][r] = float(lo[a])
        o3[b][r] = float(lo[b]) - 1.0
        d3[b][r] = 1.0
        t0[r] = BIG


def _k3_plain(data, o3, d3, t0, counts=False):
    return wide._traverse_plain(*data.k3, o3, d3, t0,
                                wide.stack_size(data.pw_max_stack),
                                counts=counts)


def test_wide_kernel_matches_plain(cuda):
    """K3 against its plain version over the same tables, bit for bit,
    with three rays lying in face planes of the scene's bounding box:
    their slab tests meet 0 * inf = NaN, which both versions propagate, so
    both miss."""
    data = Scene(_objects(), max_leaf_tris=16).send(cuda)
    o3, d3, t0 = _rays(3000, cuda)
    _face_plane_rays(data, o3, d3, t0)
    ov = wide.overflow_tensor(cuda)
    ov.zero_()
    before = _kernels.launch_counts["wide_traversal"]
    tk, sk, uk, vk = wide.traverse_wide(data, o3, d3, t0)
    assert _kernels.launch_counts["wide_traversal"] == before + 1
    tp, sp, up, vp, dropped = _k3_plain(data, o3, d3, t0)
    torch.cuda.synchronize()
    assert int(ov.item()) == 0 and int(dropped) == 0
    hit = (tp < BIG) & (tp > -BIG)
    assert int(hit.sum()) > 1000
    assert (tk[3:6] == BIG).all() and (tp[3:6] == BIG).all()
    for a, b in ((tk, tp), (sk, sp), (uk, up), (vk, vp)):
        assert torch.equal(a, b)
    assert (tk[t0 <= -BIG] == -BIG).all()  # dead rays accept nothing


@pytest.mark.parametrize("leaf", [8, 32])
def test_wide_kernel_both_columns_match_plain(cuda, leaf):
    """Both compiled group columns (16 and 71) give the plain version's
    hits, with a later part's entry t, at leaves of up to one and up to
    four octets."""
    data = Scene(_objects(1500), max_leaf_tris=leaf).send(cuda)
    o3, d3, t0 = _rays(4096, cuda, seed=7)
    t0 = torch.where(torch.arange(4096, device=cuda) % 3 == 0,
                     torch.full_like(t0, 3.0), t0)
    ref = _k3_plain(data, o3, d3, t0)[:4]
    ov = wide.overflow_tensor(cuda)
    for groups in wide.GROUPS:
        ov.zero_()
        got = wide._traverse_cuda(*data.k3, o3, d3, t0, groups, ov)
        assert int(ov.item()) == 0
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_k3_profile_matches_kernel(cuda):
    """The K3 profile build (probes/k3.py) finds the kernel's hits, counts
    the plain version's visits, leaves, candidates, octets and triangles
    tested, counts each leaf entry by its first octet, reads only the
    entered leaves' own octets, and counts its launches apart."""
    from opengl_raytracer_torch.probes import k3 as k3_probe

    data = Scene(_objects(), max_leaf_tris=32).send(cuda)
    o3, d3, t0 = _rays(3000, cuda, seed=6)
    kernel = wide.traverse_wide(data, o3, d3, t0)
    before = dict(_kernels.launch_counts)
    hits, stages, hist = k3_probe.profile(data, o3, d3, t0)
    assert _kernels.launch_counts["k3_profile"] == before["k3_profile"] + 1
    assert (_kernels.launch_counts["wide_traversal"]
            == before["wide_traversal"])
    for a, b in zip(hits, kernel):
        assert torch.equal(a, b)
    counts = _k3_plain(data, o3, d3, t0, counts=True)[5].long()
    assert stages["visits"] == int(counts[0].sum())
    assert stages["leaves"] == int(counts[1].sum())
    assert stages["candidates"] == int(counts[2].sum())
    assert stages["octets"] == int(counts[3].sum())
    assert stages["slots"] == int(counts[4].sum())
    share = k3_probe.own_share(data, hist, stages)
    assert share["entries"] == stages["leaves"]
    assert share["own_share"] == share["own_slot_share"] == 1.0
    assert all(stages[s] > 0 for s in k3_probe.STAGES)


def test_k3_octet_fetch_matches_tiles(cuda):
    """Octets read on the card by K3's own triangle loads equal
    ``unpack_octets`` of the same rows of ``data.k3`` bit for bit, the
    triangle tiles' slices (``test_torch_k3.py`` holds the two equal; the
    TPU probe's octets 0, 1, 7, 8, 9, 100, 101, 555 and the last)."""
    from opengl_raytracer_torch.probes import k3 as k3_probe

    data = Scene(_objects(1200), max_leaf_tris=32).send(cuda)
    Q = data.k3[1].shape[0]
    idx = [q for q in (0, 1, 7, 8, 9, 100, 101, 555) if q < Q] + [Q - 1]
    assert len(idx) >= 8
    before = _kernels.launch_counts["k3_fetch"]
    got = k3_probe.octet_fetch(data, idx)
    assert _kernels.launch_counts["k3_fetch"] == before + 1
    want = torch.from_numpy(unpack_octets(data.k3[1][idx].cpu().numpy()))
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_k2_probe_kernels_match_plain(cuda):
    """Both row-fetch sums of probes/k2.py equal their plain version bit
    for bit, on a table whose row count is not a multiple of anything."""
    from opengl_raytracer_torch.probes import k2 as k2_probe

    table, table_t, slots = k2_probe.probe_inputs(3, R=100_003, S=3_031,
                                                  device=cuda)
    before = _kernels.launch_counts["k2_probe"]
    rows = k2_probe.rows_sum(table, slots)
    cols = k2_probe.cols_sum(table_t, slots)
    assert _kernels.launch_counts["k2_probe"] == before + 2
    plain = k2_probe.sum_plain(table[slots.long()].unbind(1))
    assert torch.equal(rows, plain) and torch.equal(cols, plain)
    cpu = k2_probe.rows_sum(table.cpu(), slots.cpu())
    assert torch.equal(cpu, plain.cpu())


def test_k3_wrapper_rejects_bad_tables(cuda):
    """K3's Hopper tables of the wrong shape, type or device, or not on a
    16-byte boundary, are refused before any launch."""
    data = Scene(_objects(), max_leaf_tris=16).send(cuda)
    nodes, octets = data.k3
    tiles = torch.zeros((2, 8, 128), device=cuda)  # the TPU's tile shape
    o3, d3, t0 = _rays(256, cuda)
    before = _kernels.launch_counts["wide_traversal"]
    bad = [((nodes.cpu(), octets), "is on"),
           ((nodes, octets.cpu()), "is on"),
           ((nodes.float(), octets), "dtype"),
           ((nodes, octets.double()), "dtype"),
           ((tiles.view(torch.int32), octets), "must be"),
           ((nodes, tiles), "must be"),
           ((nodes[:0], octets), "must be"),
           ((nodes, octets.reshape(-1)[1:97].reshape(1, 96)), "aligned")]
    for k3, match in bad:
        with pytest.raises(ValueError, match=match):
            wide.traverse_wide(data._replace(k3=k3), o3, d3, t0)
    assert _kernels.launch_counts["wide_traversal"] == before


def test_raycast_subblock_multi_part_matches_cpu(cuda, monkeypatch):
    """The part-chaining wrapper on the card against the same wrapper on
    the CPU (plain version), on a scene split into several parts."""
    orig = scene_mod.build_subblock_parts
    monkeypatch.setattr(scene_mod, "build_subblock_parts",
                        lambda *a, **k: orig(*a, budget_bytes=64 * 1024))
    scene = Scene(_objects(1200), max_leaf_tris=16)
    on_card, on_cpu = scene.send(cuda), scene.send("cpu")
    assert len(on_card.k1_parts) > 1
    o3, d3, _ = _rays(4096, cuda, seed=2)
    active = torch.from_numpy(np.random.default_rng(3).uniform(size=4096)
                              < 0.8)
    got = sbt.raycast_subblock(on_card, o3, d3, active.to(cuda))
    ref = sbt.raycast_subblock(on_cpu, tuple(x.cpu() for x in o3),
                               tuple(x.cpu() for x in d3), active)
    torch.testing.assert_close(got.t.cpu(), ref.t, rtol=1e-6, atol=1e-6)
    assert torch.equal(got.tri.cpu(), ref.tri)
    assert torch.equal(got.slot.cpu(), ref.slot)
    assert (got.t.cpu()[~active] == BIG).all()


@pytest.mark.parametrize("n_parts", [1, 2, 4, 16])
def test_sixteen_part_chain_matches_plain(cuda, monkeypatch, n_parts):
    """K1's chain in one launch over 1 part, 2, the card's cap of 4 and
    the JAX split's cap of 16 (``test_torch_parts.py``'s small Cornell
    scene, under its small budgets past one part) on the card against the
    same chain's plain version on the CPU: the nearest hits bit for bit,
    on live and inactive rays, then from entry t's of the caller's: live
    rays, dead ones (-BIG) and rays whose entry t is nearer than most hits.
    A segment launches G5's prologue and one chain kernel walking P
    parts, and nothing else."""
    from test_torch_parts import _rays as cornell_rays
    from test_torch_parts import SPLITS, cornell, small_budget

    if n_parts > 1:
        small_budget(monkeypatch, *SPLITS[n_parts])
    _, scene, on_card, _, _ = cornell(cuda)
    on_cpu = scene.send("cpu")
    assert len(on_card.k1_parts) == n_parts
    o3, d3, active = cornell_rays(16384)
    o3c, d3c = tuple(x.to(cuda) for x in o3), tuple(x.to(cuda) for x in d3)
    before = dict(_kernels.launch_counts)
    got = sbt.raycast_subblock(on_card, o3c, d3c, active.to(cuda))
    ref = sbt.raycast_subblock(on_cpu, o3, d3, active)
    assert {k: n - before[k] for k, n in _kernels.launch_counts.items()
            if n != before[k]} == {"wide_epilogue": 1,
                                   "subblock_traversal": 1,
                                   "subblock_parts": n_parts}
    assert (ref.t < BIG).sum() > active.sum() * 0.9
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)
    assert (ref.t[~active] == BIG).all()

    t0 = torch.full((16384,), BIG)
    t0[::5] = -BIG
    t0[1::5] = 0.5
    got = sbt.traverse_parts(on_card, o3c, d3c, t0.to(cuda))
    ref = sbt.traverse_parts(on_cpu, o3, d3, t0)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)
    dead = t0 == -BIG
    assert (ref.t[dead] == BIG).all() and (ref.slot[dead] == 0).all()
    assert (ref.tri[dead] == on_cpu.k1_parts[0][2][0]).all()
    assert (ref.t[1::5] == 0.5).sum() > 1000  # entry t kept, nothing nearer


@pytest.mark.parametrize("lambertian", [True, False])
def test_shade_kernel_matches_plain(cuda, lambertian):
    data = Scene(_objects(), max_leaf_tris=16).send(cuda)
    R = 5000
    g = np.random.default_rng(4)
    f32 = np.float32

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

    t = g.uniform(0.1, 10, R).astype(f32)
    t[g.uniform(size=R) < 0.2] = BIG
    u = g.uniform(0, 1, R).astype(f32)
    v = (g.uniform(0, 1, R) * (1 - u)).astype(f32)
    d = g.normal(size=(3, R))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    near = Nearest(t=dev(t), tri=dev(np.zeros(R, np.int32)), u=dev(u),
                   v=dev(v), slot=dev(g.integers(-2, data.sh_slot.shape[0] + 2,
                                                 R).astype(np.int32)))
    col3 = lambda a: tuple(dev(a[k]) for k in range(3))  # noqa: E731
    args = (data.sh_slot, near.slot, near,
            col3(g.uniform(-4, 4, (3, R)).astype(f32)),
            col3(d.astype(f32)), col3(g.uniform(0, 1, (3, R)).astype(f32)),
            col3(g.uniform(0, 1, (3, R)).astype(f32)),
            dev(g.uniform(size=R) < 0.8),
            dev(g.integers(0, 2**32, R, dtype=np.uint64).astype(np.int64)),
            _block(cuda, lambertian=lambertian, sky=0.7))
    before = _kernels.launch_counts["shade"]
    got = shade.shade_update(*args)
    assert _kernels.launch_counts["shade"] == before + 1
    ref = shade._shade_plain(*args)
    for gk, rk in zip(got[:4], ref[:4]):
        for a in range(3):
            torch.testing.assert_close(gk[a], rk[a], rtol=1e-5, atol=1e-6)
    assert torch.equal(got[4], ref[4])
    assert torch.equal(got[5], ref[5])
    assert (got[5] >= 0).all() and (got[5] < 2**32).all()


def test_kernel_wrappers_reject_bad_input(cuda):
    data = Scene(_objects(), max_leaf_tris=16).send(cuda)
    o3, d3, t0 = _rays(256, cuda)
    with pytest.raises(ValueError, match="dtype"):
        sbt.traverse_parts(data, o3, d3, t0.double())
    strided = torch.zeros(512, device=cuda)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        sbt.traverse_parts(data, (strided, *o3[1:]), d3, t0)
    with pytest.raises(ValueError, match="group column"):
        wide._traverse_cuda(*data.k3, o3, d3, t0, 100,
                            wide.overflow_tensor(cuda))


def test_k1_wrapper_rejects_bad_tables(cuda):
    """K1's Hopper tables of the wrong shape, type or device, or not on a
    16-byte boundary, are refused before any launch; so are a bad remap,
    more than 16 parts and rays of another length."""
    data = Scene(_objects(), max_leaf_tris=16).send(cuda)
    nodes, octets, remap = data.k1_parts[0]
    rows = torch.zeros((8, 128), device=cuda)  # the TPU's row shape
    o3, d3, t0 = _rays(256, cuda)
    before = _kernels.launch_counts["subblock_traversal"]
    bad = [((nodes.cpu(), octets), "is on"),
           ((nodes, octets.cpu()), "is on"),
           ((nodes.float(), octets), "dtype"),
           ((nodes, octets.double()), "dtype"),
           ((rows.view(torch.int32), octets), "must be"),
           ((nodes, rows), "must be"),
           ((nodes[:0], octets), "must be"),
           ((nodes, octets.reshape(-1)[1:97].reshape(1, 96)), "aligned")]
    for k1, match in bad:
        with pytest.raises(ValueError, match=match):
            sbt.traverse_parts(data._replace(k1_parts=((*k1, remap),)), o3,
                               d3, t0)
    # the chain kernel's own: each part's remap, the number of parts, rays
    for part, match in (((nodes, octets, remap.long()), "dtype"),
                        ((nodes, octets, remap.cpu()), "is on"),
                        ((nodes, octets, remap[:0]), "must be"),
                        ((nodes, octets, remap[None]), "must be")):
        with pytest.raises(ValueError, match=match):
            sbt.traverse_parts(data._replace(k1_parts=(part,)), o3, d3, t0)
    with pytest.raises(ValueError, match="1 to 16 parts"):
        sbt.traverse_parts(data._replace(k1_parts=data.k1_parts * 17), o3,
                           d3, t0)
    with pytest.raises(ValueError, match="elements"):
        sbt.traverse_parts(data, o3, d3, t0[:-1])
    assert _kernels.launch_counts["subblock_traversal"] == before


@pytest.mark.parametrize("traversal", ["pallas2", "pallas"])
def test_render_on_card_matches_cpu(cuda, traversal):
    soup, _, light = _objects()  # no enclosing box: misses see the sky
    scene = Scene([soup, light], max_leaf_tris=16)
    cam = make_camera([0.0, 0.0, 4.4], (180.0, 0.0))
    imgs = []
    for device in (cuda, "cpu"):
        r = Renderer(scene, RenderConfig(width=24, height=16, bounces=2,
                                         tile_size=2, traversal=traversal),
                     device=device)
        assert r.traversal == traversal
        imgs.append(r.image(r.render(cam, frames=2)))
    assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0.01
    assert rmse(imgs[0], imgs[1]) < 1e-4


def test_sharded_on_card_matches_cpu(cuda):
    """A 96x54 frame of a (2, 2) mesh of the one card ("auto": K1 + K2 on
    every shard) against the same mesh of the CPU; the scene is uploaded
    to the card once."""
    from opengl_raytracer_torch.parallel import ShardedRenderer, make_mesh

    soup, _, light = _objects()
    scene = Scene([soup, light], max_leaf_tris=16)
    cam = make_camera([0.0, 0.0, 4.4], (180.0, 0.0))
    cfg = RenderConfig(width=96, height=54, bounces=2)
    imgs = []
    for device in (cuda, torch.device("cpu")):
        sr = ShardedRenderer(scene, cfg, make_mesh(devices=[device] * 4,
                                                   dp=2, sp=2))
        assert sr.traversal == "pallas2" and list(sr.scenes) == [device]
        before = _kernels.launch_counts["subblock_traversal"]
        imgs.append(sr.image(sr.render(cam, frames=2)))
        launched = _kernels.launch_counts["subblock_traversal"] - before
        assert launched == (len(sr.scene.k1_parts) * cfg.n_bounces * 4
                            if device.type == "cuda" else 0)
    assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0.01
    assert rmse(imgs[0], imgs[1]) < 1e-4


def test_app_on_card_matches_cpu(cuda, tmp_path):
    """A 24x16 headless App render ("auto": K1 + K2 on the card) against
    the same App on the CPU."""
    from opengl_raytracer_torch.app import App

    soup, _, light = _objects()
    scene = Scene([soup, light], max_leaf_tris=16)
    imgs = []
    for device in (cuda, torch.device("cpu")):
        app = App(window_size=(24, 16), bounces=2, scene=scene, headless=True,
                  max_frames=2, output=str(tmp_path / f"{device.type}.png"),
                  run=False, device=device)
        app.camPos = np.array([0.0, 0.0, 4.4], np.float32)
        app.camDir = np.array([180.0, 0.0], np.float32)
        app.camera = app._make_camera()
        app.main()
        assert app.renderer.traversal == "pallas2"
        imgs.append(app.image())
    assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0.01
    assert rmse(imgs[0], imgs[1]) < 1e-4


@pytest.mark.parametrize("shape", [(1080, 1920), (7, 5)])
def test_to_uint8_kernel_matches_to_uint8(cuda, shape):
    """The display conversion on the card equals ``to_uint8`` bit for bit
    on the CPU tests' cases (below 0, above 1, 0 and 1, every step and half
    step and their neighbours, random), at 1080p (one launch) and at 7x5,
    whose last channel the tail launch converts; a misaligned frame is
    refused."""
    from opengl_raytracer_torch.ops import display
    from opengl_raytracer_torch.utils.image import to_uint8
    from test_torch_display import conversion_cases

    h, w = shape
    values = np.concatenate(list(conversion_cases().values()))
    if h * w * 3 < values.size:
        values = np.random.default_rng(3).permutation(values)
    img = np.resize(values, h * w * 3).reshape(h, w, 3)
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=cuda)
    before = _kernels.launch_counts["to_uint8"]
    display.to_uint8(torch.from_numpy(img).to(cuda), out)
    assert _kernels.launch_counts["to_uint8"] == before + (
        1 if (h * w * 3) % 4 == 0 else 2)
    np.testing.assert_array_equal(out.cpu().numpy(), to_uint8(img))
    odd = torch.zeros(h * w * 3 + 1, device=cuda)[1:].view(h, w, 3)
    with pytest.raises(ValueError, match="aligned"):
        display.to_uint8(odd, out)


def test_app_frame_on_card(cuda):
    """``App.frame`` on the card: the first frame captures the step's
    graph and no moving frame captures another; each frame presents the
    previous sweep's bytes, ``to_uint8`` of its ``accum``, from pinned
    host memory, two buffers in turn, one conversion launch a frame."""
    from opengl_raytracer_torch.app import App
    from opengl_raytracer_torch.utils import profiling
    from opengl_raytracer_torch.utils.image import to_uint8

    soup, _, light = _objects()
    app = App(window_size=(24, 16), bounces=2,
              scene=Scene([soup, light], max_leaf_tris=16), headless=True,
              run=False, device=cuda)
    app.camPos = np.array([0.0, 0.0, 4.4], np.float32)
    app.camDir = np.array([180.0, 0.0], np.float32)
    app.canMove = True
    app.resetFrames()
    shown, swept = [], []

    def sink(image, frame_count):
        assert image.is_pinned() and image.device.type == "cpu"
        shown.append((image.clone(), frame_count, image.data_ptr()))

    captures = profiling.counts().get("step.captures", 0)
    launches = _kernels.launch_counts["to_uint8"]
    script = ["w", "", "", "a", "a", "", "s", ""]
    for n, key in enumerate(script):
        app.frame(key, (20, 0) if key else (0, 0), sink)
        if n == 0:
            captures += 1
        assert profiling.counts()["step.captures"] == captures
        swept.append((to_uint8(app.image()), app.state.frame_count))
    assert app.renderer.traversal == "pallas2"
    assert _kernels.launch_counts["to_uint8"] == launches + len(script)
    assert len(shown) == len(script) - 1
    for (image, count, _), (want, want_count) in zip(shown, swept):
        assert count == want_count
        np.testing.assert_array_equal(image.numpy(), want)
    ptrs = [p for _, _, p in shown]
    assert len(set(ptrs)) == 2 and all(p != q for p, q in zip(ptrs, ptrs[1:]))


# ------------------------------------------- the glue kernels (G1-G4)

def _block(device, frame=0, window=(0, 0, 0, 0, 0), lambertian=True,
           sky=1.0, jitter=0.05, accum=None):
    """A step block on ``device`` with these values."""
    from opengl_raytracer_torch.ops import step_block

    block = step_block.new(device)
    step_block.write(block, step_block.pack(
        frame, window, make_camera([-33.7, 14.8, -21.1], (65.0, -25.4)), sky,
        jitter, lambertian, 0 if accum is None else accum.data_ptr()))
    return block


# (frame, col0, py0, frames_per_step, band rows, width, height, base): a
# 1080p band at a frame number near 2^32; four frames a step that wrap
# past it, with a chunk that ends in padding; pixel coordinates whose
# products with 1973 and 9277 wrap mod 2^32 at a frame past 2^40
FRONT_CASES = {
    "frame_int": (2**32 - 1, 0, 1080 - 37, 1, 37, 1920, 1080, 0),
    "frame_tensor_wrap": (2**32 - 2, 0, 500, 4, 10, 1920, 1080, 6900),
    "wide_pixels": (2**40 + 3, 2**31 - 1921, 2**31 - 12, 1, 10, 2**31 - 1,
                    2**31 - 1, 0),
}


@pytest.mark.parametrize("aspect", [None, 1.25])
@pytest.mark.parametrize("case", sorted(FRONT_CASES))
def test_ray_front_kernel_matches_plain(cuda, case, aspect):
    from opengl_raytracer_torch.ops import front

    frame, col0, py0, F, rows, width, height, base = FRONT_CASES[case]
    block = _block(cuda, frame, (col0, py0, 0, 0, 0))
    n_band = 1920 * rows
    args = (block, base, 70_001, F * n_band, n_band, 1920, width, height,
            aspect)
    before = _kernels.launch_counts["ray_front"]
    o3, d3, seed = front.ray_front(*args)
    assert _kernels.launch_counts["ray_front"] == before + 1
    ro3, rd3, rseed = front.ray_front_plain(*args)
    for a, b in zip((*o3, *d3, seed), (*ro3, *rd3, rseed)):
        assert a.is_contiguous() and a.dtype == b.dtype and torch.equal(a, b)


def _odd_rays(R, cuda, seed=12):
    """Rays in and out of a box, with NaN and +-inf in their origin and
    direction columns, and dead rays."""
    g = np.random.default_rng(seed)
    o = g.uniform(-6, 6, (3, R)).astype(np.float32)
    o[:, :64] = g.uniform(-1e6, 1e6, (3, 64))
    d = g.normal(size=(3, R))
    d = (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)
    special = np.float32([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45])
    for a in range(3):
        o[a, 64 + a * 40:104 + a * 40] = np.resize(special, 40)
        d[a, 200 + a * 40:240 + a * 40] = np.resize(special, 40)
    alive = g.uniform(size=R) < 0.8
    return (tuple(torch.from_numpy(o[a].copy()).to(cuda) for a in range(3)),
            tuple(torch.from_numpy(d[a].copy()).to(cuda) for a in range(3)),
            torch.from_numpy(alive).to(cuda))


def test_sort_keys_kernel_matches_plain(cuda):
    """The int32 keys equal the plain version's on the card, NaN and
    infinite columns included (torch.clamp lets NaN through and the card
    converts it as the kernel does), with and without an alive mask."""
    from opengl_raytracer_torch.ops import morton

    o3, d3, alive = _odd_rays(50_001, cuda)
    lo = np.asarray([-4.0, -2.5, -3.0], np.float32)
    hi = np.asarray([5.0, 3.5, 2.0], np.float32)
    for mask in (alive, None):
        before = _kernels.launch_counts["sort_keys"]
        got = morton.sort_keys(o3, d3, lo, hi, mask)
        assert _kernels.launch_counts["sort_keys"] == before + 1
        ref = morton.sort_keys_i32_plain(o3, d3, lo, hi, mask)
        assert got.dtype == torch.int32 and torch.equal(got, ref)
    assert (got[:64] != got[64]).any()  # the far rays are not all one key


def _stable_sort(keys):
    keys_s, perm = torch.sort(keys, stable=True)
    return keys_s, perm.int()


def _same_sort(got, keys):
    want = _stable_sort(keys)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.int32 and a.device == keys.device
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", SORT_KINDS)
@pytest.mark.parametrize("n", [1, 255, 2047, 2049, 518_400, 2_073_600])
def test_radix_sort_is_the_stable_sort(cuda, kind, n):
    """G10's (keys_s, perm) equal ``torch.sort(keys, stable=True)``'s, the
    indices as int32, bit for bit: at one key, under a warp, one tile
    (2,048 keys below 2^20) less and more one, a quarter frame and a
    frame (tiles of 4,096), on each kind of keys; a sort counts its
    histogram launch and four passes."""
    from opengl_raytracer_torch.ops import radix_sort

    keys = sort_keys_case(kind, n, seed=n).to(cuda)
    before = _kernels.launch_counts["radix_sort"]
    got = radix_sort.sort_rays(keys)
    assert _kernels.launch_counts["radix_sort"] == before + 5
    _same_sort(got, keys)


@pytest.mark.parametrize("items", [8, 16])
@pytest.mark.parametrize("n", [4095, 4097, 518_400])
def test_radix_sort_designs_are_the_stable_sort(cuda, items, n):
    """Both tile sizes of G10 (2,048 and 4,096 keys; ``design`` picks one
    by the count) sort as the library does at one and two tiles and at a
    quarter frame, with dead keys among 16 distinct values; a sort
    launches 5 kernels."""
    from opengl_raytracer_torch.ops import radix_sort

    keys = sort_keys_case("distinct16", n, seed=7).to(cuda)
    keys[::5] = sort_keys_case("dead", 1)[0]
    before = _kernels.launch_counts["radix_sort"]
    got = radix_sort._sort_cuda(keys, items)
    assert _kernels.launch_counts["radix_sort"] == before + 5
    _same_sort(got, keys)


def test_radix_sort_on_a_frames_keys(cuda, monkeypatch):
    """G2's keys of a 1080p frame's second segment (the first sort, taken
    from the renderer's warm-up): G10 sorts them as the library does, and
    two runs give the same bytes."""
    from opengl_raytracer_torch.ops import radix_sort

    taken = []
    sort_rays = radix_sort.sort_rays

    def spy(keys):
        taken.append(keys.clone())
        return sort_rays(keys)

    monkeypatch.setattr(radix_sort, "sort_rays", spy)
    r = Renderer(_scene_small(), RenderConfig(width=1920, height=1080,
                                              bounces=2), device=cuda)
    r.render(make_camera(*_CAMS[0]), frames=1)
    monkeypatch.undo()
    torch.cuda.synchronize()
    keys = taken[0]
    assert keys.numel() == 1920 * 1080
    dead = int((keys == sort_keys_case("dead", 1)[0]).sum())
    assert 0 < dead < keys.numel()
    first = radix_sort.sort_rays(keys)
    _same_sort(first, keys)
    again = radix_sort.sort_rays(keys)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_radix_sort_replays_in_a_cuda_graph(cuda):
    """One sort captured in a CUDA graph and replayed twice, new keys
    written into its input between the replays, sorts both as the library
    does: the histogram launch clears the passes' look-back words and
    tickets in the graph."""
    from opengl_raytracer_torch.ops import radix_sort

    n = 518_400
    keys = sort_keys_case("random", n, seed=1).to(cuda)
    radix_sort.sort_rays(keys)  # loads the kernels outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = radix_sort.sort_rays(keys)
    for kind in ("distinct16", "reversed"):
        keys.copy_(sort_keys_case(kind, n, seed=2).to(cuda))
        graph.replay()
        torch.cuda.synchronize()
        _same_sort(out, keys)


def test_radix_sort_runs_on_the_keys_card(cuda):
    """Keys on the last card (a second one where there is one) are sorted
    there, whatever card is current, as the device guard tests hold the
    other kernels."""
    from opengl_raytracer_torch.ops import radix_sort

    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    keys = sort_keys_case("random", 100_003, seed=4).to(dev)
    with torch.cuda.device(0):
        got = radix_sort.sort_rays(keys)
    torch.cuda.synchronize(dev)
    _same_sort(got, keys)


def test_permute_kernels_match_plain(cuda):
    """Reorder and restore against their plain versions bit for bit, with
    and without ``return_seed``, on a random permutation (dead rays
    scattered) and on the stable sort of the keys (dead rays at the tail,
    as the integrator runs it), at a count that leaves a part block; the
    reorder's two kernels count as two launches; restore after reorder is
    the identity."""
    from opengl_raytracer_torch.ops import morton, permute

    R = 100_003
    g = np.random.default_rng(13)
    cols = [torch.from_numpy(g.normal(size=R).astype(np.float32)).to(cuda)
            for _ in range(12)]
    keys = torch.from_numpy(g.integers(-2**31, 2**31 - 1, R)
                            .astype(np.int32)).to(cuda)
    keys[torch.from_numpy(g.uniform(size=R) < 0.3).to(cuda)] = \
        morton.DEAD_KEY32
    for c in cols[9:]:  # a live ray carries no light
        c[keys != morton.DEAD_KEY32] = 0.0
    seed = torch.from_numpy(g.integers(0, 2**32, R)).to(cuda)
    random = torch.randperm(R, device=cuda).int()
    keys_s, perm = torch.sort(keys, stable=True)
    perm = perm.int()
    orig = torch.randperm(R, device=cuda).int()
    groups = (tuple(cols[0:3]), tuple(cols[3:6]), tuple(cols[6:9]),
              tuple(cols[9:12]))
    n_dead = int((keys == morton.DEAD_KEY32).sum())

    def flat(x):
        return [y for z in x
                for y in (z if isinstance(z, tuple) else (z,))
                if y is not None]

    for ks, p in ((keys[random], random), (keys_s, perm)):
        for return_seed in (True, False):
            before = dict(_kernels.launch_counts)
            got = permute.reorder(ks, p, *groups, seed, orig, return_seed)
            seed_in = got[5] if return_seed else None
            back = permute.restore(got[3], seed_in, got[6])
            assert _kernels.launch_counts["reorder"] == before["reorder"] + 2
            assert _kernels.launch_counts["restore"] == before["restore"] + 1
            ref = permute.reorder_plain(ks, p, *groups, seed, orig,
                                        return_seed)
            for a, b in zip(flat(got), flat(ref)):
                assert a.dtype == b.dtype
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            rback = permute.restore_plain(got[3], seed_in, got[6])
            assert (back[1] is None) == (rback[1] is None) == (not return_seed)
            for a, b in zip(flat(back), flat(rback)):
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        if p is perm:
            assert not got[4][-n_dead:].any() and got[4][:-n_dead].all()
    # from pixel order (orig = arange) and back
    fwd = permute.reorder(keys_s, perm, *groups, seed,
                          torch.arange(R, dtype=torch.int32, device=cuda))
    inc, seed_back = permute.restore(fwd[3], fwd[5], fwd[6])
    for a in range(3):
        assert torch.equal(inc[a].view(torch.int32),
                           groups[3][a].view(torch.int32))
    assert torch.equal(seed_back, seed)


@pytest.mark.parametrize("frame", [2**32 - 2, 2**33 + 5])
def test_reorder_index_pass_recon_matches_plain(cuda, frame):
    """The reorder with seed reconstruction (the index pass computes a
    live ray's seed, the gather runs without its seed row) against
    ``reorder_plain`` with it, byte for byte, on a step's own states at
    bounces 1-4 with frames_per_step 2, padding rays and frame numbers
    past 2^32; its outputs equal the carried-seed reorder's; two launches
    a call.  Then a step past 2^32 rays (the index math's 64 bits)."""
    from opengl_raytracer_torch.ops import permute

    def same(a, b):
        for x, y in zip(a, b):
            if isinstance(x, tuple):
                same(x, y)
            else:
                assert x.dtype == y.dtype
                assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))

    for name, st, recon, draws in recon_states(cuda, frame):
        before = _kernels.launch_counts["reorder"]
        got = permute.reorder(*st, False, recon, draws)
        assert _kernels.launch_counts["reorder"] == before + 2, name
        same(got, permute.reorder_plain(*st, False, recon, draws))
        same(got, permute.reorder(*st, False))
    wide_recon = recon._replace(base=2**32 + 100, n_rays=2**33)
    same(permute.reorder(*st, False, wide_recon, draws),
         permute.reorder_plain(*st, False, wide_recon, draws))


@pytest.mark.parametrize("masked", [True, False])
def test_chain_kernel_resolves_hits(cuda, monkeypatch, masked):
    """The chain kernel resolves its winner as the plain chain does, on a
    scene split into several parts, bit for bit, and by each rule: a miss
    or an inactive ray gives t = BIG, u = v = 0, slot 0 and part 0's
    remap[0]; a hit's slot lies in its part's range past the part's slot
    base, and its tri is that part's remap of the slot; a slot past its
    part's remap clamps to the remap's last entry."""
    orig = scene_mod.build_subblock_parts
    monkeypatch.setattr(scene_mod, "build_subblock_parts",
                        lambda *a, **k: orig(*a, budget_bytes=64 * 1024))
    data = Scene(_objects(1200), max_leaf_tris=16).send(cuda)
    parts = data.k1_parts
    assert len(parts) > 2
    R = 8191
    o3, d3, _ = _rays(R, cuda, seed=14)
    active = (torch.from_numpy(np.random.default_rng(15).uniform(size=R)
                               < 0.7).to(cuda) if masked else None)
    t0 = wide.wide_prologue(active, R, cuda)
    ov = sbt.overflow_tensor(cuda)
    ov.zero_()
    before = dict(_kernels.launch_counts)
    got = sbt.traverse_parts(data, o3, d3, t0)
    assert _kernels.launch_counts["subblock_parts"] == (
        before["subblock_parts"] + len(parts))
    ref, dropped = sbt._chain_plain(parts, o3, d3, t0)
    assert int(ov.item()) == 0 and int(dropped) == 0
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)

    miss = got.t == BIG
    assert (got.u[miss] == 0).all() and (got.v[miss] == 0).all()
    assert (got.slot[miss] == 0).all()
    assert (got.tri[miss] == parts[0][2][0]).all()
    if masked:
        assert miss[~active].all()
    base, winners = 0, 0
    for _, _, remap in parts:
        mine = ~miss & (got.slot >= base) & (got.slot < base + remap.shape[0])
        assert torch.equal(got.tri[mine],
                           remap[(got.slot[mine] - base).long()])
        winners += int(mine.any())
        base += remap.shape[0]
    assert int((~miss).sum()) > 1000 and winners > 1

    # part 0's remap cut to 3 entries: its winners' slots clamp to 2
    full = got
    cut = ((*parts[0][:2], parts[0][2][:3].clone()), *parts[1:])
    got = sbt.traverse_parts(data._replace(k1_parts=cut), o3, d3, t0)
    ref, _ = sbt._chain_plain(cut, o3, d3, t0)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    first = ~miss & (full.slot < parts[0][2].shape[0])
    assert int((full.slot[first] > 2).sum()) > 100
    assert torch.equal(got.slot[first], full.slot[first].clamp_max(2))
    assert torch.equal(got.tri[first], parts[0][2][got.slot[first].long()])


def test_glue_wrappers_reject_bad_input(cuda):
    """A wrong dtype, device or length is refused before any launch."""
    from opengl_raytracer_torch.ops import front, morton, permute, radix_sort

    R = 256
    block = _block(cuda)
    o3, d3, t0 = _rays(R, cuda)
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    keys = torch.zeros(R, dtype=torch.int32, device=cuda)
    seed = torch.zeros(R, dtype=torch.int64, device=cuda)
    slot = torch.zeros(R, dtype=torch.int32, device=cuda)
    remap = torch.zeros(8, dtype=torch.int32, device=cuda)
    bad = [
        (lambda: front.ray_front(block.long(), 0, R, R, R, 16, 16, 16,
                                 None), "dtype"),
        (lambda: front.ray_front(block[:-1], 0, R, R, R, 16, 16, 16, None),
         "elements"),
        (lambda: front.ray_front(block, 0, R, R, R - 1, 16, 16, 16, None),
         "band"),
        (lambda: morton.sort_keys((o3[0].double(), *o3[1:]), d3, lo, hi),
         "dtype"),
        (lambda: morton.sort_keys(o3, d3, lo, hi, keys[:-1].bool()),
         "elements"),
        (lambda: permute.reorder(keys, keys.float(), o3, d3, o3, d3, seed,
                                 keys), "dtype"),
        (lambda: permute.reorder(keys.long(), seed, o3, d3, o3, d3, seed,
                                 keys), "dtype"),
        (lambda: permute.reorder(keys, seed, o3, d3, o3, d3, seed, keys),
         "dtype"),
        (lambda: permute.reorder(keys, keys, o3, d3, o3, d3, seed, seed,
                                 False), "dtype"),
        (lambda: radix_sort.sort_rays(keys.long()), "dtype"),
        (lambda: radix_sort.sort_rays(keys[::2]), "contiguous"),
        (lambda: permute.restore(d3, seed.cpu(), keys), "is on"),
        (lambda: permute.restore(d3, None, seed), "dtype"),
        (lambda: permute.restore(d3, seed, keys[:-1]), "elements"),
    ]
    before = dict(_kernels.launch_counts)
    for call, match in bad:
        with pytest.raises(ValueError, match=match):
            call()
    assert _kernels.launch_counts == before


# ------------------------------------- the compiled step (G5, G6, graphs)

def test_step_block_write_matches_plain(cuda):
    """The block's write launch leaves the words a copy leaves."""
    from opengl_raytracer_torch.ops import step_block

    words = step_block.pack(2**33 + 5, (1, 2, 3, 4, 5),
                            make_camera([1.0, 2.0, 3.0], (10.0, 20.0)), 0.5,
                            0.25, False, accum=123456789)
    got, ref = step_block.new(cuda), step_block.new(cuda)
    before = _kernels.launch_counts["step_block"]
    step_block.write(got, words)
    assert _kernels.launch_counts["step_block"] == before + 1
    step_block.write_plain(ref, words)
    assert torch.equal(got, ref)
    assert step_block.values(got).frame == 2**33 + 5


@pytest.mark.parametrize("masked", [True, False])
def test_wide_epilogue_kernels_match_plain(cuda, masked):
    """G5's prologue and epilogue against their plain versions, on K3's own
    output for random rays with dead ones."""
    data = Scene(_objects(), max_leaf_tris=16).send(cuda)
    o3, d3, t0 = _rays(5001, cuda, seed=21)
    active = (t0 > -BIG) if masked else None
    before = _kernels.launch_counts["wide_epilogue"]
    got_t0 = wide.wide_prologue(active, 5001, cuda)
    assert torch.equal(got_t0, wide._prologue_plain(active, 5001, cuda))
    k3 = wide.traverse_wide(data, o3, d3, got_t0)
    got = wide.wide_epilogue(*k3, data.pl_remap)
    assert _kernels.launch_counts["wide_epilogue"] == before + 2
    ref = wide._epilogue_plain(*k3, data.pl_remap)
    for a, b in zip(got[:4], ref[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int((got.t < BIG).sum()) > 1000


@pytest.mark.parametrize("frame,F,tile", [(0, 1, 1), (2**24 + 1, 2, 3),
                                          (2**32 - 2, 2, 3)])
def test_band_fold_kernel_matches_plain(cuda, frame, F, tile):
    """G6 against its plain version bit for bit, every tile of a sweep of
    a 24x20 frame (remainder tiles at tile_size 3), into the buffer the
    block names."""
    from opengl_raytracer_torch.ops import fold, step_block
    from opengl_raytracer_torch.renderer import step_words

    cfg = RenderConfig(width=24, height=20, tile_size=tile,
                       frames_per_step=F)
    g = np.random.default_rng(22)
    start = torch.from_numpy(g.uniform(0, 2, (20, 24, 3))
                             .astype(np.float32)).to(cuda)
    got, ref = start.clone(), start.clone()
    tw, th = cfg.tile_w, cfg.tile_h
    cam = make_camera([0.0, 0.0, 4.4], (180.0, 0.0))
    bk, bp = step_block.new(cuda), step_block.new(cuda)
    before = _kernels.launch_counts["band_fold"]
    for ty in range(cfg.num_tiles_y):
        for tx in range(cfg.num_tiles_x):
            cols = tuple(torch.from_numpy(g.uniform(0, 3, F * tw * th + 7)
                                          .astype(np.float32)).to(cuda)
                         for _ in range(3))
            step_block.write(bk, step_words(cfg, frame, tx, ty, cam, 1.0, 0.0,
                                            True, got))
            step_block.write(bp, step_words(cfg, frame, tx, ty, cam, 1.0, 0.0,
                                            True, ref))
            fold.fold_band(got, cols, bk, tw, th, F, F)
            fold.fold_plain(ref, cols, bp, tw, th, F, F)
    tiles = cfg.num_tiles_x * cfg.num_tiles_y
    assert _kernels.launch_counts["band_fold"] == before + tiles
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert not torch.equal(got, start)


@pytest.mark.parametrize("masked", [True, False])
def test_bvh_walk_kernel_matches_plain(cuda, masked):
    """G7, the "bvh" walk, against its plain version bit for bit, with
    axis-parallel rays, rays in face planes of the scene's box (NaN slab
    values) and, masked, dead rays."""
    from opengl_raytracer_torch.ops import traversal

    data = Scene(_objects(), max_leaf_tris=4).send(cuda)
    o3, d3, t0 = _rays(3001, cuda, seed=23)
    _face_plane_rays(data, o3, d3, t0)
    active = (t0 > -BIG) if masked else None
    leaf = effective_max_leaf(data)
    before = _kernels.launch_counts["bvh_walk"]
    got = traversal.raycast_bvh(data, o3, d3, active, leaf)
    assert _kernels.launch_counts["bvh_walk"] == before + 1
    ref = traversal._walk_plain(data, o3, d3, active, leaf)
    for a, b in zip(got[:4], ref[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int((got.t < BIG).sum()) > 1000


def _edge_rays(data, o3, d3, first, n, seed):
    """Rays ``first .. first + n - 1`` aimed at the midpoint of a random
    triangle's first edge, which the quad's other triangle shares: hits
    on u = 0 or v = 0 and ties at equal t."""
    from opengl_raytracer_torch.ops.intersect import unpack_tri_records

    g = np.random.default_rng(seed)
    k = torch.from_numpy(g.integers(0, data.num_tris, n)).to(data.device)
    v0, e1, _, _ = unpack_tri_records(data.tri_records)
    target = v0[k] + 0.5 * e1[k]
    o = torch.stack([x[first:first + n] for x in o3], dim=1)
    d = target - o
    d = d / d.norm(dim=1, keepdim=True)
    for a in range(3):
        d3[a][first:first + n] = d[:, a]


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("kind", ["box", "soup"])
def test_brute_sweep_kernel_matches_plain(cuda, kind, masked):
    """G8, the brute-force sweep, against its plain version bit for bit:
    the box's 84 triangles (one partial tile) with rays aimed at shared
    quad edges (ties), the soup's 400-odd (two tiles), axis-parallel rays,
    rays in face planes of the scene's box and, masked, dead rays; an
    all-dead batch misses everywhere."""
    from opengl_raytracer_torch.ops import intersect

    data = (Scene(box_objects()) if kind == "box"
            else Scene(_objects(), max_leaf_tris=16)).send(cuda)
    assert (data.num_tris <= 256) == (kind == "box")
    o3, d3, t0 = _rays(3001, cuda, seed=29)
    _face_plane_rays(data, o3, d3, t0)
    _edge_rays(data, o3, d3, 6, 200, seed=30)
    active = (t0 > -BIG) if masked else None
    before = _kernels.launch_counts["brute_sweep"]
    got = intersect.raycast_brute(data, o3, d3, active)
    assert _kernels.launch_counts["brute_sweep"] == before + 1
    ref = intersect._sweep_plain(data, o3, d3, active)
    for a, b in zip(got[:4], ref[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int((got.t < BIG).sum()) > 1000
    none = intersect.raycast_brute(data, o3, d3,
                                   torch.zeros_like(t0, dtype=torch.bool))
    assert _kernels.launch_counts["brute_sweep"] == before + 2
    assert (none.t == BIG).all() and not none.tri.any()


def _wide_node_records(data):
    """``data``'s node records in the 48-byte form (first and count
    whole), which a scene takes when they do not fit the 32-byte record's
    bits."""
    from opengl_raytracer_torch.ops import traversal

    narrow = data.node_records
    _, _, _, first, count = traversal.unpack_node_records(narrow)
    return torch.cat((narrow[:, :7], first[:, None], count[:, None],
                      torch.zeros_like(narrow[:, :3])), 1).contiguous()


def test_bvh_walk_kernel_reads_wide_node_records(cuda):
    """G7 over 48-byte node records (first and count whole, the form a
    scene takes when they do not fit the 32-byte record's bits) equals its
    plain version bit for bit; the records give the tables back."""
    from opengl_raytracer_torch.ops import traversal

    data = Scene(_objects(), max_leaf_tris=4).send(cuda)
    narrow = data.node_records
    assert narrow.shape[1] == 8
    wide_rec = _wide_node_records(data)
    for a, b in zip(traversal.unpack_node_records(wide_rec),
                    traversal.unpack_node_records(narrow)):
        assert torch.equal(a, b)
    data = data._replace(node_records=wide_rec)
    o3, d3, t0 = _rays(3001, cuda, seed=31)
    active = t0 > -BIG
    leaf = effective_max_leaf(data)
    before = _kernels.launch_counts["bvh_walk"]
    got = traversal.raycast_bvh(data, o3, d3, active, leaf)
    assert _kernels.launch_counts["bvh_walk"] == before + 1
    ref = traversal._walk_plain(data, o3, d3, active, leaf)
    for a, b in zip(got[:4], ref[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int((got.t < BIG).sum()) > 1000


@pytest.mark.parametrize("records", ["narrow", "wide"])
@pytest.mark.parametrize("masked", [True, False])
def test_packet_walk_kernel_matches_plain(cuda, masked, records):
    """G9, the packet walk, against its plain version bit for bit: axis-
    parallel rays, rays in face planes of the scene's box (NaN slab
    values), rays aimed at shared quad edges (ties) and, masked, dead
    rays and a packet whose rays are all dead; over 32- and 48-byte node
    records.  An all-dead batch misses everywhere."""
    from opengl_raytracer_torch.ops import traversal

    data = Scene(_objects(), max_leaf_tris=4).send(cuda)
    if records == "wide":
        data = data._replace(node_records=_wide_node_records(data))
    o3, d3, t0 = _rays(3072, cuda, seed=37)
    _face_plane_rays(data, o3, d3, t0)
    _edge_rays(data, o3, d3, 6, 200, seed=38)
    t0[256:384] = -BIG  # packet 2: no live ray
    active = (t0 > -BIG) if masked else None
    leaf = effective_max_leaf(data)
    before = _kernels.launch_counts["packet_walk"]
    got = traversal.raycast_packet(data, o3, d3, active, leaf)
    assert _kernels.launch_counts["packet_walk"] == before + 1
    ref = traversal._packet_plain(data, o3, d3, active, leaf)
    for a, b in zip(got[:4], ref[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int((got.t < BIG).sum()) > 1000
    if masked:
        assert (got.t[256:384] == BIG).all() and not got.tri[256:384].any()
    none = traversal.raycast_packet(data, o3, d3,
                                    torch.zeros_like(t0, dtype=torch.bool),
                                    leaf)
    assert _kernels.launch_counts["packet_walk"] == before + 2
    assert (none.t == BIG).all() and not none.tri.any()
    with pytest.raises(ValueError, match="multiple of packet"):
        traversal.raycast_packet(data, tuple(x[:200] for x in o3),
                                 tuple(x[:200] for x in d3), None, leaf)


@pytest.mark.parametrize("records", ["narrow", "wide"])
def test_packet_walk_kernel_warps_match_plain(cuda, records):
    """G9, a 128-thread block a packet, bit for bit against its plain
    version: in packet 1 + k every ray of warp k (rays 128 p + 32 k ..
    + 31) is dead (k = 0..3), yet the warp takes part in every vote and
    stages its share of each leaf; packet 5 has one live ray, packet 6 one
    live ray in a face plane of the scene's box (a NaN slab value: it
    opens nothing, so its packet walks nothing), packet 7 none; rays in
    face planes and at shared quad edges (exact-t ties) in packet 0 and
    random rays from packet 8 on (11 packets); over 32- and 48-byte node
    records."""
    from opengl_raytracer_torch.ops import traversal

    data = Scene(_objects(), max_leaf_tris=4).send(cuda)
    if records == "wide":
        data = data._replace(node_records=_wide_node_records(data))
    R = 11 * 128
    o3, d3, t0 = _rays(R, cuda, seed=41)
    _face_plane_rays(data, o3, d3, t0)
    _edge_rays(data, o3, d3, 6, 100, seed=42)
    t0[128:1024] = BIG
    for k in range(4):  # packet 1 + k: warp k dead
        first = 128 * (1 + k) + 32 * k
        t0[first:first + 32] = -BIG
    t0[640:768] = -BIG
    t0[640 + 77] = BIG  # packet 5: one live ray
    t0[768:896] = -BIG
    for a in range(3):  # packet 6: one live ray, in a face plane
        o3[a][768 + 40] = o3[a][4]
        d3[a][768 + 40] = d3[a][4]
    t0[768 + 40] = BIG
    t0[896:1024] = -BIG  # packet 7: none
    active = t0 > -BIG
    leaf = effective_max_leaf(data)
    before = _kernels.launch_counts["packet_walk"]
    got = traversal.raycast_packet(data, o3, d3, active, leaf)
    assert _kernels.launch_counts["packet_walk"] == before + 1
    ref = traversal._packet_plain(data, o3, d3, active, leaf)
    for a, b in zip(got[:4], ref[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (got.t[~active] == BIG).all() and not got.tri[~active].any()
    assert float(got.t[640 + 77]) < BIG and float(got.t[768 + 40]) == BIG
    for k in range(4):
        p = slice(128 * (1 + k), 128 * (2 + k))
        assert int((got.t[p] < BIG).sum()) > 48


@pytest.mark.parametrize("build", ["unbuilt", "two_large_leaves"])
def test_packet_walk_kernel_stages_large_leaves(cuda, build):
    """G9 bit for bit against its plain version where a leaf holds more
    triangles than the block has threads, so it is staged 128 records at a
    time with a barrier before each later chunk and a partial last chunk:
    one leaf of 324 triangles (``build_bvh=False``), and two SAH leaves of
    306 and 318 under ``max_leaf_tris=512`` (a packet stages one, then the
    other).  Dead rays, a packet with no live ray (2), one with one live
    ray (3), one with a dead warp (4), rays in face planes and at shared
    quad edges."""
    from opengl_raytracer_torch.ops import traversal

    kw = (dict(build_bvh=False) if build == "unbuilt"
          else dict(max_leaf_tris=512))
    data = Scene(_objects(300 if build == "unbuilt" else 600),
                 **kw).send(cuda)
    counts = traversal.unpack_node_records(data.node_records)[4]
    counts = counts[counts > 0]
    assert len(counts) == (1 if build == "unbuilt" else 2)
    assert (counts > 256).all() and (counts % 128 > 0).all()
    R = 8 * 128
    o3, d3, t0 = _rays(R, cuda, seed=47)
    _face_plane_rays(data, o3, d3, t0)
    _edge_rays(data, o3, d3, 6, 100, seed=48)
    t0[256:384] = -BIG  # packet 2: no live ray
    t0[384:512] = -BIG
    t0[384 + 99] = BIG  # packet 3: one live ray
    t0[512 + 32:512 + 64] = -BIG  # packet 4: its second warp dead
    active = t0 > -BIG
    leaf = effective_max_leaf(data)
    before = _kernels.launch_counts["packet_walk"]
    got = traversal.raycast_packet(data, o3, d3, active, leaf)
    assert _kernels.launch_counts["packet_walk"] == before + 1
    ref, work = traversal._packet_plain(data, o3, d3, active, leaf,
                                        counts=True)
    for a, b in zip(got[:4], ref[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (got.t[~active] == BIG).all() and not got.tri[~active].any()
    assert float(got.t[384 + 99]) < BIG
    assert int(work.slots.max()) == int(counts.sum())  # every leaf staged
    assert int((got.t < BIG).sum()) > 600


def _det_edge_scene(cuda):
    """The demo box and one flat triangle inside it, v0 (-1, -1, 0.5), e1
    (2, 0, 0), e2 (0, 2, 0): face (0, 0, 4), so a ray along z with
    direction (0, 0, s) has det = 4 s exactly."""
    tri = np.array([[[-1, -1, 0.5], [1, -1, 0.5], [-1, 1, 0.5]]],
                   np.float32)
    return Scene([*box_objects(), Triangles(tri, color=(0.5, 0.5, 0.5),
                                            roughness=1.0)]).send(cuda)


def _det_edge_rays(R, cuda, seed):
    """R rays (R a multiple of 128) along z at the flat triangle from
    below (z -0.5) and above (z 1.5), inside it or beside it, with det =
    +-EPS, one float below and above it, and +-2 EPS: t = 4 (0.5 - z) /
    det, some 4e6; a tenth dead."""
    g = np.random.default_rng(seed)
    eps = np.float32(1e-6)
    dets = np.array([eps, np.nextafter(eps, np.float32(0)),
                     np.nextafter(eps, np.float32(1)), 2 * eps], np.float32)
    det = dets[np.arange(R) % 4] * np.where(np.arange(R) // 4 % 2, -1, 1)
    o = np.zeros((3, R), np.float32)
    o[0] = np.where(g.uniform(size=R) < 0.8, -0.5, 1.5)  # inside, beside
    o[1] = -0.5
    o[2] = np.where(np.arange(R) // 8 % 2, 1.5, -0.5)
    d = np.zeros((3, R), np.float32)
    d[2] = det / np.float32(4)  # exact: a power of two
    t0 = np.where(g.uniform(size=R) < 0.1, -BIG, BIG).astype(np.float32)
    return (tuple(torch.from_numpy(o[a].copy()).to(cuda) for a in range(3)),
            tuple(torch.from_numpy(d[a].copy()).to(cuda) for a in range(3)),
            torch.from_numpy(t0).to(cuda))


@pytest.mark.parametrize("kernel", ["bvh_walk", "brute_sweep",
                                    "packet_walk"])
def test_walk_kernels_at_the_det_edge(cuda, kernel):
    """G7, G8 and G9 (G7 tests the sign of t before its division, G8 and
    G9 divide wherever |det| >= EPS) against their plain versions bit for
    bit on rays
    whose det is +-EPS, one float either side of it and +-2 EPS, ahead of
    the triangle and behind it: exactly the live rays with |det| >= EPS
    that head for it from within its outline hit it (t 2e6-4e6)."""
    from opengl_raytracer_torch.ops import intersect, traversal

    data = _det_edge_scene(cuda)
    o3, d3, t0 = _det_edge_rays(1024, cuda, seed=43)
    active = t0 > -BIG
    leaf = effective_max_leaf(data)
    run, plain = {
        "bvh_walk": (traversal.raycast_bvh, traversal._walk_plain),
        "brute_sweep": (intersect.raycast_brute, intersect._sweep_plain),
        "packet_walk": (traversal.raycast_packet,
                        traversal._packet_plain)}[kernel]
    args = (data, o3, d3, active) + (() if kernel == "brute_sweep"
                                     else (leaf,))
    before = _kernels.launch_counts[kernel]
    got = run(*args)
    assert _kernels.launch_counts[kernel] == before + 1
    ref = plain(*args)
    for a, b in zip(got[:4], ref[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the flat triangle is hit at 2e6-4e6, the box's far walls past 6e7
    flat = (got.t > 1e6) & (got.t < 1e7)
    can = ((d3[2] * (0.5 - o3[2]) > 0) & (d3[2].abs() * 4 >= 1e-6)
           & (o3[0] < 1) & active)
    assert int(flat.sum()) > 100 and torch.equal(flat, can)


def test_brute_sweep_kernel_blocks_and_tiles(cuda):
    """G8, a block of 256 rays, bit for bit against its plain version:
    2,999 rays (the last block partly past the end), 300-odd triangles
    (two tiles of 256), two blocks whose rays are all dead (they skip the
    sweep), blocks dead in one half only, rays in face planes and at
    shared quad edges."""
    from opengl_raytracer_torch.ops import intersect

    data = Scene(_objects(300), max_leaf_tris=16).send(cuda)
    assert 256 < data.num_tris <= 512
    R = 2999
    o3, d3, t0 = _rays(R, cuda, seed=44)
    _face_plane_rays(data, o3, d3, t0)
    _edge_rays(data, o3, d3, 6, 200, seed=45)
    t0[512:1024] = -BIG  # blocks 2 and 3: no live ray
    t0[1024:1152] = -BIG  # block 4: its first half dead
    t0[2048 + 128:2304] = -BIG  # block 8: its second half dead
    active = t0 > -BIG
    before = _kernels.launch_counts["brute_sweep"]
    got = intersect.raycast_brute(data, o3, d3, active)
    assert _kernels.launch_counts["brute_sweep"] == before + 1
    ref = intersect._sweep_plain(data, o3, d3, active)
    for a, b in zip(got[:4], ref[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (got.t[~active] == BIG).all() and not got.tri[~active].any()
    assert not got.u[~active].any() and not got.v[~active].any()
    assert int((got.t[2560:] < BIG).sum()) > 200


@pytest.mark.parametrize("F,base", [(1, 0), (2, 6900)])
def test_ray_front_kernel_blocks_match_plain(cuda, F, base):
    """G1 in the packet traversal's 8x16 block order against its plain
    version bit for bit: a 16-row band of a 1080p frame at a frame number
    past 2^32, ``F`` copies of it, a chunk that ends in padding rays; a
    chunk from ray 0 holds the row-major chunk's rays permuted."""
    from opengl_raytracer_torch.ops import front

    block = _block(cuda, 2**32 - 1, (0, 1080 - 16, 0, 0, 0))
    n_band = 1920 * 16
    args = (block, base, 70_001, F * n_band, n_band, 1920, 1920, 1080, None)
    before = _kernels.launch_counts["ray_front"]
    o3, d3, seed = front.ray_front(*args, blocks=True)
    assert _kernels.launch_counts["ray_front"] == before + 1
    ro3, rd3, rseed = front.ray_front_plain(*args, blocks=True)
    for a, b in zip((*o3, *d3, seed), (*ro3, *rd3, rseed)):
        assert a.is_contiguous() and a.dtype == b.dtype and torch.equal(a, b)
    rows = front.ray_front(*args)[2]
    assert not torch.equal(seed, rows)
    if base == 0:  # the whole band and padding: the same rays permuted
        assert torch.equal(seed.sort()[0], rows.sort()[0])


@pytest.mark.parametrize("F", [1, 2])
def test_band_fold_kernel_blocks_match_plain(cuda, F):
    """G6 in 8x16 block order against its plain version bit for bit,
    every tile of a 64x48 frame at tile_size 2 (32x24 tiles, whole
    blocks), ``F`` frames a step, into the buffer the block names."""
    from opengl_raytracer_torch.ops import fold, step_block
    from opengl_raytracer_torch.renderer import packet_blocks, step_words

    cfg = RenderConfig(width=64, height=48, tile_size=2, frames_per_step=F,
                       traversal="packet")
    assert packet_blocks(cfg, "packet")
    g = np.random.default_rng(23)
    start = torch.from_numpy(g.uniform(0, 2, (48, 64, 3))
                             .astype(np.float32)).to(cuda)
    got, ref = start.clone(), start.clone()
    tw, th = cfg.tile_w, cfg.tile_h
    cam = make_camera([0.0, 0.0, 4.4], (180.0, 0.0))
    bk, bp = step_block.new(cuda), step_block.new(cuda)
    before = _kernels.launch_counts["band_fold"]
    for ty in range(cfg.num_tiles_y):
        for tx in range(cfg.num_tiles_x):
            cols = tuple(torch.from_numpy(g.uniform(0, 3, F * tw * th)
                                          .astype(np.float32)).to(cuda)
                         for _ in range(3))
            step_block.write(bk, step_words(cfg, 2**24 + 1, tx, ty, cam, 1.0,
                                            0.0, True, got))
            step_block.write(bp, step_words(cfg, 2**24 + 1, tx, ty, cam, 1.0,
                                            0.0, True, ref))
            fold.fold_band(got, cols, bk, tw, th, F, F, blocks=True)
            fold.fold_plain(ref, cols, bp, tw, th, F, F, blocks=True)
    assert _kernels.launch_counts["band_fold"] == before + 4
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert not torch.equal(got, start)


def _scene_small():
    soup, _, light = _objects()  # no enclosing box: misses see the sky
    return Scene([soup, light], max_leaf_tris=16)


# Each step of the script: (camera, sky, lambertian, reset before it)
_CAMS = ([0.0, 0.0, 4.4], (180.0, 0.0)), ([0.5, -0.3, 4.0], (175.0, 6.0))


def _script(n_tiles):
    steps = []
    for k in range(2 * n_tiles + 3):
        cam = _CAMS[1] if k >= n_tiles + 1 else _CAMS[0]  # a camera move
        sky = 0.6 if k % 3 == 2 else 1.0  # a sky change
        lam = k % 2 == 0  # lambertian toggles
        reset = k == n_tiles + 1  # the App resets when the camera moves
        steps.append((make_camera(*cam), sky, lam, reset))
    return steps


def _buffers(accum):
    """``accum``'s tensors: a mesh's slices, or the one buffer."""
    return getattr(accum, "slices", (accum,))


def _replay_vs_eager(graphed, eager, n_tiles, check_graph=True):
    """Run the same script of steps through ``graphed.step`` (replays) and
    ``eager._step_eager``, holding ``accum`` (on a mesh, each slice) bit
    for bit after each."""
    sa, sb = graphed.init_state(), eager.init_state()
    for camera, sky, lam, reset in _script(n_tiles):
        if reset:
            old = _buffers(sa.accum)
            sa, sb = graphed.reset(sa), eager.reset(sb)
            assert all(a.data_ptr() != b.data_ptr()
                       for a, b in zip(_buffers(sa.accum), old))
        sa = graphed.step(sa, camera, sky_brightness=sky, lambertian=lam)
        sb = eager._step_eager(sb, camera, sky_brightness=sky,
                               lambertian=lam)
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(_buffers(sa.accum), _buffers(sb.accum),
                                   strict=True))
        assert (sa.frame_count, sa.tile_x, sa.tile_y) == (
            sb.frame_count, sb.tile_x, sb.tile_y)
    bufs = _buffers(sa.accum)
    assert sum(float(a.sum()) for a in bufs) / sum(a.numel()
                                                   for a in bufs) > 0.01
    return sa


@pytest.mark.parametrize("traversal", ["auto", "brute", "bvh", "packet",
                                       "pallas", "pallas2"])
@pytest.mark.parametrize("cfg", [dict(tile_size=2), dict(tile_size=3),
                                 dict(frames_per_step=2, rays_per_pixel=2)])
def test_graph_replay_equals_eager_body(cuda, traversal, cfg):
    """Replayed steps equal the eager body bit for bit through a camera
    move, a reset (a new accum: the block carries its address), lambertian
    toggles and sky changes, for every traversal name; one graph serves
    every tile, remainder tiles (24x16 at tile_size 3) included."""
    scene = _scene_small()
    config = RenderConfig(width=24, height=16, bounces=2,
                          traversal=traversal, **cfg)
    graphed = Renderer(scene, config, device=cuda)
    eager = Renderer(scene, config, device=cuda)
    n_tiles = config.num_tiles_x * config.num_tiles_y
    _replay_vs_eager(graphed, eager, n_tiles)
    assert graphed._graph is not None and eager._graph is None


@pytest.mark.parametrize("cfg", [dict(width=32, height=16),
                                 dict(width=64, height=32, tile_size=2,
                                      frames_per_step=2)])
def test_graph_replay_equals_eager_packet_blocks(cuda, cfg):
    """"packet" with the band's rays in 8x16 blocks (G1, G9, G6 in block
    order, the seed carried through the reorders): replayed steps equal
    the eager body bit for bit through the script."""
    from opengl_raytracer_torch.renderer import packet_blocks

    config = RenderConfig(bounces=2, traversal="packet", **cfg)
    assert packet_blocks(config, "packet")
    graphed = Renderer(_scene_small(), config, device=cuda)
    eager = Renderer(_scene_small(), config, device=cuda)
    _replay_vs_eager(graphed, eager, config.num_tiles_x * config.num_tiles_y)
    assert graphed._graph is not None


@pytest.mark.parametrize("traversal", ["pallas2", "pallas"])
def test_graph_replay_equals_eager_at_cadence_two(cuda, traversal):
    """At sort_every=2 (4 bounces: reorders before segments 1 and 3, the
    kernels on one-sort-stale rays at 2 and 4) replayed steps equal the
    eager body bit for bit through the script."""
    scene = _scene_small()
    config = RenderConfig(width=24, height=16, bounces=4, tile_size=2,
                          traversal=traversal, sort_every=2)
    graphed = Renderer(scene, config, device=cuda)
    eager = Renderer(scene, config, device=cuda)
    _replay_vs_eager(graphed, eager, config.num_tiles_x * config.num_tiles_y)


@pytest.mark.parametrize("traversal", ["pallas2", "pallas"])
def test_cadence_frames_equal_on_card(cuda, traversal):
    """Two frames at sort_every 1, 2 and 4 (4 bounces) are equal bit for
    bit with the kernels, each with its cadence's reorders a frame (4, 2
    and 1: G2, G10's five launches, two reorder launches each) and one
    restore."""
    scene = _scene_small()
    cam = make_camera(*_CAMS[0])
    ref = None
    for k, sorts in ((1, 4), (2, 2), (4, 1)):
        r = Renderer(scene, RenderConfig(width=24, height=16, bounces=4,
                                         traversal=traversal, sort_every=k),
                     device=cuda)
        _kernels.reset_counts()
        accum = r.render(cam, frames=2).accum
        counts = dict(_kernels.launch_counts)
        assert counts["sort_keys"] == 2 * sorts
        assert counts["radix_sort"] == 2 * 5 * sorts
        assert counts["reorder"] == 2 * 2 * sorts
        assert counts["restore"] == 2 and counts["shade"] == 2 * 5
        ref = accum if ref is None else ref
        assert torch.equal(accum.view(torch.int32), ref.view(torch.int32))
    assert float(ref.mean()) > 0.01


def test_graph_counts_replays_and_keeps_the_overflow_counters(cuda):
    """The counters created before capture are the ones the replays add
    to (a captured allocation would reset them on every replay); each
    replay adds the launches its capture made, and set-up adds none."""
    scene = _scene_small()
    config = RenderConfig(width=24, height=16, bounces=2)
    r = Renderer(scene, config, device=cuda)
    assert r.traversal == "pallas2"
    ovs = [sbt.overflow_tensor(cuda), wide.overflow_tensor(cuda)]
    for ov in ovs:
        ov.fill_(5)
    _kernels.reset_counts()
    state = r.step(r.init_state(), make_camera(*_CAMS[0]))
    counts = dict(_kernels.launch_counts)
    n = config.n_bounces
    parts = len(r.scene.k1_parts)
    assert counts["subblock_traversal"] == n and counts["shade"] == n
    assert counts["subblock_parts"] == parts * n
    assert counts["ray_front"] == counts["band_fold"] == 1
    # the first step writes its own block and the next step's behind it;
    # each later one, found written, writes the next step's
    assert counts["step_block"] == 2 and counts["restore"] == 1
    assert counts["wide_epilogue"] == n and counts["wide_traversal"] == 0
    for _ in range(3):
        state = r.step(state, make_camera(*_CAMS[0]))
    assert _kernels.launch_counts == {
        k: 5 if k == "step_block" else 4 * v for k, v in counts.items()}
    torch.cuda.synchronize()
    for ov in ovs:
        assert int(ov.item()) == 5
    assert [sbt.overflow_tensor(cuda), wide.overflow_tensor(cuda)] == ovs


def test_graph_steps_with_blocks_written_ahead_equal_eager(cuda):
    """64 replayed steps, the camera moved every 5th step (with a reset
    every other move, as the App resets), equal the same steps through
    ``_step_eager`` with every block written at its step, bit for bit;
    the steps that found their block written ahead are all but the first
    and those after a move."""
    from opengl_raytracer_torch.utils import profiling

    scene = _scene_small()
    config = RenderConfig(width=24, height=16, bounces=2, tile_size=2)
    graphed = Renderer(scene, config, device=cuda)
    eager = Renderer(scene, config, device=cuda)
    sa, sb = graphed.init_state(), eager.init_state()
    camera = make_camera(*_CAMS[0])
    found = []
    for k in range(64):
        if k and k % 5 == 0:
            camera = make_camera([0.05 * k, -0.02 * k, 4.4],
                                 (180.0 - 0.5 * k, 0.1 * k))
            if k % 10 == 0:
                sa, sb = graphed.reset(sa), eager.reset(sb)
        hits = profiling.counts().get("step.block_ahead_hits", 0)
        sa = graphed.step(sa, camera)
        found.append(profiling.counts().get("step.block_ahead_hits", 0)
                     - hits)
        eager._ahead = (None, None)
        sb = eager._step_eager(sb, camera)
        assert torch.equal(sa.accum.view(torch.int32),
                           sb.accum.view(torch.int32)), k
    assert found == [int(k % 5 != 0) for k in range(64)]
    assert graphed._graph is not None and eager._graph is None
    assert float(sa.accum.mean()) > 0.01


def test_device_sync_reads_what_was_queued(cuda):
    """``device_sync`` returns the old read's value bit for bit (float and
    int tensors, a strided view) and returns only after the card has run
    what was queued before it: a value written behind a long kernel."""
    from opengl_raytracer_torch.utils.profiling import device_sync

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((64, 48), device=cuda, generator=g)
    for t in (x, x.t(), (x * 1000).to(torch.int32)):
        old = float(t.reshape(-1)[:4].sum())
        new = device_sync(t)
        assert np.float64(new).view(np.int64) == np.float64(old).view(
            np.int64)
    y = torch.zeros(16, device=cuda)
    for v in (2.5, -7.25, 0.125):
        torch.cuda._sleep(50_000_000)
        y.fill_(v)
        assert device_sync(y) == 4 * v
        assert torch.cuda.current_stream(cuda).query()


def test_graph_follows_new_buffers(cuda):
    """A checkpoint's state (``state_from_numpy``) and a restored copy
    are new buffers; the one graph folds into each."""
    from opengl_raytracer_torch.renderer import state_from_numpy

    scene = _scene_small()
    config = RenderConfig(width=24, height=16, bounces=2, tile_size=2)
    graphed = Renderer(scene, config, device=cuda)
    eager = Renderer(scene, config, device=cuda)
    cam = make_camera(*_CAMS[0])
    sa = graphed.render(cam, frames=1)
    graph = graphed._graph
    g = np.random.default_rng(5).uniform(0, 1, (16, 24, 3))
    sa = state_from_numpy(g, 1, 1, 0, 5, cuda)
    sb = state_from_numpy(g, 1, 1, 0, 5, cuda)
    for _ in range(5):
        sa, sb = graphed.step(sa, cam), eager._step_eager(sb, cam)
    assert graphed._graph is graph
    assert torch.equal(sa.accum, sb.accum)


def test_sharded_graph_replay_equals_eager(cuda):
    """A (2, 2) mesh of the one card: each shard's replay and the owners'
    folds equal the eager body bit for bit through the same script, and a
    shard is one graph."""
    from opengl_raytracer_torch.parallel import ShardedRenderer, make_mesh

    scene = _scene_small()
    cfg = RenderConfig(width=24, height=16, bounces=2, tile_size=2)
    mesh = make_mesh(devices=[cuda] * 4, dp=2, sp=2)
    graphed, eager = ShardedRenderer(scene, cfg, mesh), \
        ShardedRenderer(scene, cfg, mesh)
    _replay_vs_eager(graphed, eager, cfg.num_tiles_x * cfg.num_tiles_y)
    graphs = [sh.graph for row in graphed._shards for sh in row]
    assert all(g is not None for g in graphs) and len(set(graphs)) == 4
    assert all(sh.graph is None for row in eager._shards for sh in row)


@pytest.mark.parametrize("dp,tile_size", [(4, 1), (4, 5), (2, 3)])
def test_sharded_slices_match_sequential_on_card(cuda, dp, tile_size):
    """An sp = 1 mesh of the one card folds each band piece into its
    owner's slice by the address in the slice's block: equal to the
    sequential renderer on the card bit for bit.  At 24x24 and dp 4 the
    slices have 6 rows: tile_size 1 gives each dp row its slice, tile_size
    5 a remainder band and pieces of one row; at dp 2 tile_size 3 cuts
    pieces of 4 rows across slices of 12."""
    from opengl_raytracer_torch.parallel import ShardedRenderer, make_mesh

    scene = _scene_small()
    cfg = RenderConfig(width=24, height=24, bounces=2, tile_size=tile_size)
    cam = make_camera([0.0, 0.0, 4.4], (180.0, 0.0))
    sr = ShardedRenderer(scene, cfg, make_mesh(devices=[cuda] * dp, dp=dp,
                                               sp=1))
    r = Renderer(scene, cfg, device=cuda)
    before = _kernels.launch_counts["band_fold"]
    got = sr.image(sr.render(cam, frames=2))
    parts = sum(len(sr._plans[t][1]) for t in sr._plans)
    assert _kernels.launch_counts["band_fold"] - before == 2 * parts
    np.testing.assert_array_equal(got, r.image(r.render(cam, frames=2)))
    assert got.mean() > 0.01 and sr.moved_bytes == 0


def test_sharded_marks_one_span_per_owner_card(cuda):
    """A traced (4, 1) mesh over the cards there are (one repeated where
    there are fewer than four): each step records one ``mesh.fold`` and
    one ``mesh.card`` device span an owner card, read at the sync of
    every card, which returns slice 0's head sum."""
    from opengl_raytracer_torch.parallel import ShardedRenderer, make_mesh
    from opengl_raytracer_torch.utils import profiling

    n = torch.cuda.device_count()
    devices = [torch.device("cuda", k % n) for k in range(4)]
    cfg = RenderConfig(width=24, height=24, bounces=2)
    sr = ShardedRenderer(_scene_small(), cfg,
                         make_mesh(devices=devices, dp=4, sp=1))
    cam = make_camera([0.0, 0.0, 4.4], (180.0, 0.0))
    state = sr.render(cam, frames=1)  # captures each shard's graph
    profiling.clear()
    profiling.enable(True)
    try:
        for _ in range(2):
            state = sr.step(state, cam)
            got = profiling.device_sync(state.accum)
            assert got == float(state.accum.slices[0].reshape(-1)[:4].sum())
    finally:
        profiling.enable(False)
    spans = profiling.spans()
    cards = sorted((s.step, s.args["card"]) for s in spans
                   if s.name == "mesh.card")
    steps = sorted({step for step, _ in cards})
    assert len(steps) == 2
    assert cards == [(step, j) for step in steps for j in range(4)]
    assert all(s.args["device_ms"] > 0 for s in spans
               if s.name == "mesh.card")
    assert sorted(s.step for s in spans if s.name == "mesh.fold") == steps
    profiling.clear()


def test_sharded_issues_the_slowest_card_first(cuda, monkeypatch):
    """A mesh over distinct cards (2 or 4 where there are) times its owner
    cards at its second step and, once the events have completed, issues
    the slowest card's shards first; the frames are the sequential
    renderer's bit for bit whatever the order.  A mesh of one card
    repeated keeps the rows' order and times nothing."""
    from opengl_raytracer_torch.parallel import ShardedRenderer, make_mesh
    from opengl_raytracer_torch.parallel import sharding

    n = torch.cuda.device_count()
    dp = 4 if n >= 4 else 2
    devices = [torch.device("cuda", k % n) for k in range(dp)]
    cfg = RenderConfig(width=24, height=24, bounces=2)
    scene = _scene_small()
    sr = ShardedRenderer(scene, cfg, make_mesh(devices=devices, dp=dp, sp=1))
    r = Renderer(scene, cfg, device=cuda)
    cam = make_camera([0.0, 0.0, 4.4], (180.0, 0.0))
    timed = []
    plain = sharding._slowest_first
    monkeypatch.setattr(sharding, "_slowest_first",
                        lambda clock: timed.append(plain(clock)) or
                        tuple(reversed(timed[-1])))
    a, b = sr.init_state(), r.init_state()
    for _ in range(4):
        a, b = sr.step(a, cam), r.step(b, cam)
        got = sr.image(a)  # waits for every card
    if n >= dp:
        assert len(timed) == 1 and sorted(timed[0]) == list(range(dp))
        assert sr._order == tuple(reversed(timed[0]))
    else:
        assert timed == [] and sr._order == tuple(range(dp))
    np.testing.assert_array_equal(got, r.image(b))


def test_failed_capture_raises(cuda):
    """A body that syncs with the host cannot be captured: capture raises
    and leaves the launch counts as they were."""
    from opengl_raytracer_torch import step_graph

    x = torch.ones(4, device=cuda)
    before = dict(_kernels.launch_counts)
    with pytest.raises(RuntimeError):
        step_graph.capture(lambda: float(x.sum()), cuda, warmup=lambda: None)
    assert _kernels.launch_counts == before
    torch.cuda.synchronize()
