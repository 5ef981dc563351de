"""G3: the integrator's reorder and restore permutations.

Before every bounce segment but the first, :func:`reorder` moves the
per-ray state into the order of the rays' sorted coherence keys; after
the last, :func:`restore` scatters the light (and the seed, when the
caller returns it) back to pixel order: the multi-operand sorts of
``opengl_raytracer_tpu/ops/integrator.py:209-268`` and ``:336-354``.

The reorder moves only what the frame reads again, with the JAX sort's
folds (``integrator.py:226-235, :259-268``): a live ray's incoming light
is zero (light is added only where a path ends), so it is written as
+0.0 and not read; a dead ray's origin, direction and ray colour are never
read again (the traversals skip it, the shade kernel selects on its hit),
so they are written as 0.0 and not read, and its light is read; its seed
is read only with ``return_seed`` (``rays_per_pixel > 1`` chains the seed
across samples), else written as 0.  ``alive`` is the sorted key's ``!=
DEAD_KEY32``; the original index is int32, as the JAX package's
(``integrator.py:323``).

Seed reconstruction (``recon``, a :class:`SeedRecon`; only with
``return_seed`` off, as the JAX integrator's ``seed_recon``,
``integrator.py:237-249``): a live ray's seed is not read but recomputed
from its original index.  Before bounce segment ``i >= 1`` a live ray has
drawn exactly ``5 + 3i`` values since its pixel seed (G1's three warm-ups
and two jitter draws, then three at every segment it lived through: K2
draws three for every ray and keeps the new state exactly where the ray
was alive and hit, and only hits keep a ray alive), so its seed is
``rng.advance_n(rng.seed_pixels(px, py, frame), 5 + 3i)`` of the pixel and
frame number G1 gave ray ``base + orig`` (``front.band_pixels``, padding
rays included).  A dead ray's seed stays 0.  So the reorder's outputs are
the same bytes with and without it; the card's gather reads one column
fewer.

On CUDA tensors each is one call of ``csrc/permute.cu`` (the reorder
launches two kernels, an index pass and the gather, and counts both); on
CPU tensors they run :func:`reorder_plain` and :func:`restore_plain`.
Both copy and select, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from opengl_raytracer_torch.ops import _kernels, rng, step_block
from opengl_raytracer_torch.ops.front import band_pixels
from opengl_raytracer_torch.ops.morton import DEAD_KEY32


class SeedRecon(NamedTuple):
    """How the rays of a chunk got their seeds: ray ``i`` of the chunk is
    ray ``base + i`` of a step of ``n_rays`` rays over a band of ``n_band``
    pixels, ``tw`` a row, with the window and frame number of the step
    ``block`` (``front.ray_front``'s arguments).  Fixed for a renderer's
    chunk; the block's values are read when the reorder runs."""

    block: torch.Tensor
    base: int
    n_rays: int
    n_band: int
    tw: int


def recon_seeds(recon: SeedRecon, orig, alive, draws: int):
    """Plain version of the reconstruction: the seed of each sorted ray of
    original index ``orig`` after ``draws`` draws, 0 where not ``alive``
    (int64 uint32 states, ``ops/rng.py``)."""
    v = step_block.values(recon.block)
    px, py, frames = band_pixels(v.col0, v.py0, v.frame, recon.base,
                                 orig.numel(), recon.n_rays, recon.n_band,
                                 recon.tw, orig.device, index=orig)
    seed = rng.advance_n(rng.seed_pixels(px, py, frames), draws)
    return torch.where(alive, seed, 0)


def _check_recon(recon, return_seed: bool) -> None:
    if recon is not None and return_seed:
        raise ValueError("seed reconstruction drops the seed: it needs "
                         "return_seed off")


def reorder_plain(keys_s, perm, origin, direction, ray_color, incoming, seed,
                  orig, return_seed: bool = True,
                  recon: SeedRecon | None = None, draws: int = 0):
    """Plain version: the 12 float columns gathered by ``perm`` as the
    rows of one (12, R) buffer, a live ray's incoming light and a dead
    ray's origin, direction and ray colour zeroed, a dead ray's seed zeroed
    unless ``return_seed``; with ``recon`` a live ray's seed is
    :func:`recon_seeds` after ``draws`` draws.  Returns (origin, direction,
    ray_color, incoming, alive, seed, orig) in the sorted order."""
    _check_recon(recon, return_seed)
    alive = keys_s != DEAD_KEY32
    cols = torch.stack([*origin, *direction, *ray_color, *incoming])[:, perm]
    cols[:9] = torch.where(alive, cols[:9], 0.0)
    cols[9:] = torch.where(alive, 0.0, cols[9:])
    origin, direction, ray_color, incoming = (
        tuple(cols[3 * g + a] for a in range(3)) for g in range(4))
    orig = orig[perm]
    if recon is not None:
        seed = recon_seeds(recon, orig, alive, draws)
    else:
        seed = seed[perm]
        if not return_seed:
            seed = torch.where(alive, seed, 0)
    return origin, direction, ray_color, incoming, alive, seed, orig


def restore_plain(incoming, seed, orig):
    """Plain version: ``incoming`` and ``seed`` (or None) scattered to each
    ray's original index; returns (incoming 3-tuple, seed or None)."""
    light = torch.stack(incoming)
    out = torch.empty_like(light)
    out[:, orig] = light
    seed_out = None
    if seed is not None:
        seed_out = torch.empty_like(seed)
        seed_out[orig] = seed
    return tuple(out[a] for a in range(3)), seed_out


def _reorder_cuda(keys_s, perm, origin, direction, ray_color, incoming, seed,
                  orig, return_seed: bool = True,
                  recon: SeedRecon | None = None, draws: int = 0):
    _check_recon(recon, return_seed)
    dev = keys_s.device
    R = keys_s.shape[0]
    req = _kernels.require
    if R >= 2**31:
        raise ValueError(f"{R} rays: the reorder's int32 index holds fewer "
                         f"than 2^31")
    blk, rc = None, (0, 0, 0, 0, 0, 0)
    if recon is not None:
        req(recon.block, "block", torch.int32, dev, step_block.WORDS)
        if recon.tw < 1 or recon.n_band % recon.tw:
            raise ValueError(f"a band of {recon.n_band} pixels in rows of "
                             f"{recon.tw}")
        blk = recon.block.data_ptr()
        rc = (recon.base, recon.n_rays, recon.n_band, recon.tw,
              *rng.advance_constants(draws))
    req(keys_s, "keys_s", torch.int32, dev, R)
    req(perm, "perm", torch.int32, dev, R)
    req(seed, "seed", torch.int64, dev, R)
    req(orig, "orig", torch.int32, dev, R)
    cols = (*origin, *direction, *ray_color, *incoming)
    for k, x in enumerate(cols):
        req(x, f"float column {k}", torch.float32, dev, R)
    ptrs = (ctypes.c_void_p * 12)(*(x.data_ptr() for x in cols))
    pa = torch.empty(R, dtype=torch.int32, device=dev)
    out = torch.empty((12, R), dtype=torch.float32, device=dev)
    seed_out = torch.empty(R, dtype=torch.int64, device=dev)
    orig_out = torch.empty(R, dtype=torch.int32, device=dev)
    alive = torch.empty(R, dtype=torch.bool, device=dev)
    _kernels.launch("oglrt_reorder", "reorder", dev, perm.data_ptr(),
                    keys_s.data_ptr(), ptrs, seed.data_ptr(),
                    orig.data_ptr(), pa.data_ptr(), out.data_ptr(),
                    seed_out.data_ptr(), orig_out.data_ptr(),
                    alive.data_ptr(), int(return_seed), blk, *rc, R,
                    kernels=2)
    origin, direction, ray_color, incoming = (
        tuple(out[3 * g + a] for a in range(3)) for g in range(4))
    return origin, direction, ray_color, incoming, alive, seed_out, orig_out


def _restore_cuda(incoming, seed, orig):
    dev = orig.device
    R = orig.shape[0]
    _kernels.require(orig, "orig", torch.int32, dev, R)
    if seed is not None:
        _kernels.require(seed, "seed", torch.int64, dev, R)
    for a, x in enumerate(incoming):
        _kernels.require(x, f"incoming {a}", torch.float32, dev, R)
    out = torch.empty((3, R), dtype=torch.float32, device=dev)
    seed_out = None if seed is None else torch.empty_like(seed)
    _kernels.launch("oglrt_restore", "restore", dev, orig.data_ptr(),
                    *(x.data_ptr() for x in incoming),
                    None if seed is None else seed.data_ptr(),
                    out.data_ptr(),
                    None if seed_out is None else seed_out.data_ptr(), R)
    return (out[0], out[1], out[2]), seed_out


def reorder(keys_s, perm, origin, direction, ray_color, incoming, seed, orig,
            return_seed: bool = True, recon: SeedRecon | None = None,
            draws: int = 0):
    """The per-ray state in the order ``perm``: ``keys_s, perm =
    radix_sort.sort_rays(keys)`` of the int32 keys (``perm`` int32, as
    ``torch.sort(keys, stable=True)``'s indices cast); origin, direction,
    ray colour and incoming light as
    3-tuples of (R,) float32 columns, ``seed`` (R,) int64, ``orig`` (R,)
    int32.  Returns (origin, direction, ray_color, incoming, alive, seed,
    orig), the float columns rows of one (12, R) buffer, ``alive`` the
    sorted key's ``!= DEAD_KEY32``, with the module docstring's zeros.
    ``recon`` (with ``return_seed`` off): a live ray's seed is rebuilt
    from its original index after ``draws`` draws, not read from
    ``seed``."""
    args = (keys_s, perm, origin, direction, ray_color, incoming, seed, orig,
            return_seed, recon, draws)
    return _reorder_cuda(*args) if keys_s.is_cuda else reorder_plain(*args)


def restore(incoming, seed, orig):
    """Scatter ``incoming`` (3 columns) and ``seed`` back to pixel order,
    ``out[orig[i]] = in[i]``; ``orig`` (int32) must be a permutation.
    ``seed`` None: the light alone, and None for the seed."""
    if orig.is_cuda:
        return _restore_cuda(incoming, seed, orig)
    return restore_plain(incoming, seed, orig)
