"""G10, the integrator's ray sort (``ops/radix_sort.py``), on the CPU.

On CPU keys ``sort_rays`` is ``torch.sort(keys, stable=True)`` with the
indices as int32, the sort the port ran before G10 and G10's plain
version: here it is held to the JAX package's stable sort of the uint32
keys it was made from (``lax.sort``, as ``opengl_raytracer_tpu/ops/
integrator.py`` sorts them), bit for bit, on full-range random keys,
equal keys, dead-ray keys, 16 distinct values (stability), presorted and
reversed keys, at counts about one tile of the kernel.  The integrator
sorts through it and calls no ``torch.sort`` on the card; G3's reorder
takes its int32 permutation and gives the outputs it gave with the int64
one.  The kernel itself is held to the same sort on the card
(tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengl_raytracer_torch import Rect, RenderConfig, Renderer, Scene
from opengl_raytracer_torch import Triangles, make_camera
from opengl_raytracer_torch.ops import _kernels, permute, radix_sort
from test_torch_render import CAM, _objects
from torch_states import SORT_KINDS, recon_states, sort_keys_case


def _jax_sort(keys):
    """The JAX package's order: a stable ``lax.sort`` of the uint32 keys
    (the int32 keys plus 2^31) carrying each key's index; as int32."""
    u32 = (keys.numpy().astype(np.int64) + 2**31).astype(np.uint32)
    keys_j, perm_j = jax.lax.sort(
        (jnp.asarray(u32), jnp.arange(keys.numel(), dtype=jnp.int32)),
        num_keys=1, is_stable=True)
    keys_s = (np.asarray(keys_j).astype(np.int64) - 2**31).astype(np.int32)
    return torch.from_numpy(keys_s), torch.from_numpy(np.array(perm_j))


def _same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.int32
        assert a.is_contiguous()
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", SORT_KINDS)
@pytest.mark.parametrize("n", [0, 1, 255, 2047, 2049, 9001])
def test_plain_sort_is_the_stable_sort(kind, n):
    keys = sort_keys_case(kind, n, seed=n)
    _same(radix_sort.sort_rays(keys), _jax_sort(keys))


def test_sort_rays_runs_plain_on_cpu():
    """CPU keys take the library's stable sort, indices as int32, and
    launch nothing."""
    keys = sort_keys_case("random", 5000, seed=1)
    keys_s, perm = torch.sort(keys, stable=True)
    before = dict(_kernels.launch_counts)
    _same(radix_sort.sort_rays(keys), (keys_s, perm.int()))
    assert _kernels.launch_counts == before


def test_design_tiles_every_sm():
    """A frame's keys in tiles of 4,096 (507 of them), a quarter frame's
    in tiles of 2,048 (254), so that either keeps the 132 SMs busy; the
    workspace holds both buffers, the counts and the look-back words."""
    for n, tiles in ((2_073_600, 507), (518_400, 254)):
        items = radix_sort.design(n)
        assert -(-n // (radix_sort.BLOCK * items)) == tiles
        words = radix_sort._layout_words(n, items)
        groups = -(-tiles // 16)
        assert words == (2 * n + min(-(-n // 8192), 128) * 256
                         + 4 * (tiles + groups) * 256 + 4 * 256 + 4)


@pytest.mark.parametrize("return_seed", [True, False])
def test_reorder_takes_the_int32_permutation(return_seed):
    """G3's reorder with the int32 permutation gives, bit for bit, what it
    gave with ``torch.sort``'s int64 one, with the seed carried and
    rebuilt."""
    for name, st, recon, draws in recon_states("cpu", 2**32 - 2)[:4]:
        keys_s, perm = st[:2]
        assert perm.dtype == torch.int32
        wide = (keys_s, perm.long(), *st[2:])
        cases = [((return_seed,), (return_seed,))]
        if not return_seed:
            cases.append(((False, recon, draws), (False, recon, draws)))
        for a, b in cases:
            got = permute.reorder(*st, *a)
            want = permute.reorder(*wide, *b)
            for x, y in zip(got, want):
                for p, q in zip(x if isinstance(x, tuple) else (x,),
                                y if isinstance(y, tuple) else (y,)):
                    assert p.dtype == q.dtype, name
                    assert torch.equal(p.view(torch.uint8),
                                       q.view(torch.uint8)), name


def test_frame_sorts_through_g10(monkeypatch):
    """A "pallas2" frame of 4 bounces (5 segments) sorts its rays before
    each segment but the first, each time through
    ``radix_sort.sort_rays`` with the int32 keys of every ray of the chunk
    (the pixels padded to whole packets): ``torch.sort`` runs only inside
    it, on CPU keys, and never on CUDA ones."""
    sorted_keys = []
    sort_rays = radix_sort.sort_rays
    library = torch.sort
    inside = []

    def spy(keys):
        sorted_keys.append(keys)
        inside.append(True)
        try:
            return sort_rays(keys)
        finally:
            inside.pop()

    def cpu_only(keys, *args, **kwargs):
        if keys.is_cuda or not inside:
            raise AssertionError("the main path called torch.sort")
        return library(keys, *args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("the main path called torch.argsort")

    scene = Scene(_objects(Rect, Triangles))
    monkeypatch.setattr(radix_sort, "sort_rays", spy)
    monkeypatch.setattr(torch, "sort", cpu_only)
    monkeypatch.setattr(torch, "argsort", refuse)
    r = Renderer(scene, RenderConfig(width=24, height=20, bounces=4,
                                     traversal="pallas2"), device="cpu")
    r.render(make_camera(*CAM), frames=1)
    assert r.config.n_bounces == 5 and len(sorted_keys) == 4
    assert all(k.dtype == torch.int32 and k.numel() == 512
               for k in sorted_keys)
