"""G3: the integrator's reorder and restore permutations.

Before every bounce segment but the first, :func:`reorder` moves every
per-ray column into the order of the rays' sorted coherence keys; after
the last, :func:`restore` scatters the light and the seed back to pixel
order (the multi-operand sorts of
``opengl_raytracer_tpu/ops/integrator.py:209-268`` and ``:336-354``).  On
CUDA tensors each is one launch of ``csrc/permute.cu``; on CPU tensors
they run :func:`reorder_plain` and :func:`restore_plain`, the integrator's
torch indexing.  Both are permutations, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from opengl_raytracer_torch.ops import _kernels
from opengl_raytracer_torch.ops.morton import DEAD_KEY32


def reorder_plain(keys, perm, origin, direction, ray_color, incoming, seed,
                  orig):
    """Plain version: the 12 float columns gathered by ``perm`` as the
    rows of one (12, R) buffer, and ``alive`` re-derived from the sorted
    int32 key.  Returns (origin, direction, ray_color, incoming, alive,
    seed, orig) in the sorted order."""
    cols = torch.stack([*origin, *direction, *ray_color, *incoming])
    cols = cols[:, perm]
    origin, direction, ray_color, incoming = (
        tuple(cols[3 * g + a] for a in range(3)) for g in range(4))
    alive = keys[perm] != DEAD_KEY32
    seed = seed[perm]
    orig = orig[perm]
    return origin, direction, ray_color, incoming, alive, seed, orig


def restore_plain(incoming, seed, orig):
    """Plain version: ``incoming`` and ``seed`` scattered to each ray's
    original index; returns (incoming 3-tuple, seed)."""
    light = torch.stack(incoming)
    out = torch.empty_like(light)
    out[:, orig] = light
    seed_out = torch.empty_like(seed)
    seed_out[orig] = seed
    return tuple(out[a] for a in range(3)), seed_out


def _reorder_cuda(keys, perm, origin, direction, ray_color, incoming, seed,
                  orig):
    dev = keys.device
    R = keys.shape[0]
    req = _kernels.require
    req(keys, "keys", torch.int32, dev, R)
    req(perm, "perm", torch.int64, dev, R)
    req(seed, "seed", torch.int64, dev, R)
    req(orig, "orig", torch.int64, dev, R)
    cols = (*origin, *direction, *ray_color, *incoming)
    for k, x in enumerate(cols):
        req(x, f"float column {k}", torch.float32, dev, R)
    ptrs = (ctypes.c_void_p * 12)(*(x.data_ptr() for x in cols))
    out = torch.empty((12, R), dtype=torch.float32, device=dev)
    seed_out = torch.empty(R, dtype=torch.int64, device=dev)
    orig_out = torch.empty(R, dtype=torch.int64, device=dev)
    alive = torch.empty(R, dtype=torch.bool, device=dev)
    _kernels.launch("oglrt_reorder", "reorder", dev, perm.data_ptr(),
                    keys.data_ptr(), ptrs, seed.data_ptr(), orig.data_ptr(),
                    out.data_ptr(), seed_out.data_ptr(), orig_out.data_ptr(),
                    alive.data_ptr(), R)
    origin, direction, ray_color, incoming = (
        tuple(out[3 * g + a] for a in range(3)) for g in range(4))
    return origin, direction, ray_color, incoming, alive, seed_out, orig_out


def _restore_cuda(incoming, seed, orig):
    dev = orig.device
    R = orig.shape[0]
    _kernels.require(orig, "orig", torch.int64, dev, R)
    _kernels.require(seed, "seed", torch.int64, dev, R)
    for a, x in enumerate(incoming):
        _kernels.require(x, f"incoming {a}", torch.float32, dev, R)
    out = torch.empty((3, R), dtype=torch.float32, device=dev)
    seed_out = torch.empty(R, dtype=torch.int64, device=dev)
    _kernels.launch("oglrt_restore", "restore", dev, orig.data_ptr(),
                    *(x.data_ptr() for x in incoming), seed.data_ptr(),
                    out.data_ptr(), seed_out.data_ptr(), R)
    return (out[0], out[1], out[2]), seed_out


def reorder(keys, perm, origin, direction, ray_color, incoming, seed, orig):
    """Every per-ray column in the order ``perm`` (the stable argsort of
    the int32 keys ``keys``): origin, direction, ray colour and incoming
    light as 3-tuples of (R,) float32 columns, ``seed`` and ``orig`` (R,)
    int64.  Returns (origin, direction, ray_color, incoming, alive, seed,
    orig), the float columns rows of one (12, R) buffer and ``alive`` the
    sorted key's ``!= DEAD_KEY32``."""
    args = (keys, perm, origin, direction, ray_color, incoming, seed, orig)
    return _reorder_cuda(*args) if keys.is_cuda else reorder_plain(*args)


def restore(incoming, seed, orig):
    """Scatter ``incoming`` (3 columns) and ``seed`` back to pixel order,
    ``out[orig[i]] = in[i]``; ``orig`` must be a permutation."""
    if orig.is_cuda:
        return _restore_cuda(incoming, seed, orig)
    return restore_plain(incoming, seed, orig)
