"""Ray-coherence sort keys (direction cell + Morton position), as uint32
values held in int64 tensors (see ops/rng.py for why int64).

Sorting rays by these keys before every bounce segment groups rays that
start near each other and fly the same way.  Dead rays get the reserved
sentinel ``0xFFFFFFFF`` and sort to the tail; live keys are clamped below
it, so ``alive`` can be re-derived from a sorted key
(``opengl_raytracer_tpu/ops/morton.py:47-78``).

The integrator sorts the int32 form, :func:`sort_keys` (G2: the kernel of
``csrc/sort_keys.cu`` on the card), so the radix sort runs over 32-bit
keys.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opengl_raytracer_torch.ops import _kernels

DEAD_KEY = 0xFFFFFFFF
DEAD_KEY32 = DEAD_KEY - 2**31  # INT32_MAX: the dead-ray key as int32


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so bit i lands at position 3i."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3d(q: torch.Tensor) -> torch.Tensor:
    """Interleave (..., 3) integer coordinates (the low 10 bits of each):
    bit i of axis a lands at bit 3i + a, a uint32 value in int64."""
    return (_spread3(q[..., 0]) | (_spread3(q[..., 1]) << 1)
            | (_spread3(q[..., 2]) << 2))


def _quantize(x: torch.Tensor, hi: float) -> torch.Tensor:
    return x.clamp(0.0, hi).to(torch.int64)


def ray_sort_keys_soa(o3, d3, lo, hi, alive=None) -> torch.Tensor:
    """uint32 coherence keys: quantized direction major, then coarse
    position, fine direction and fine position (the JAX package's
    ``ray_sort_keys_soa`` bit for bit).  ``o3``/``d3`` are 3-tuples of (R,)
    columns, ``lo``/``hi`` (3,) float32 NumPy arrays (the scene's root
    bounds)."""
    ext = [float(max(np.float32(hi[a] - lo[a]), np.float32(1e-6)))
           for a in range(3)]
    q = [_quantize((o3[a] - float(lo[a])) / ext[a] * 512.0, 511.0)
         for a in range(3)]
    dq = [_quantize((d3[a] * 0.5 + 0.5) * 4.0, 3.0) for a in range(3)]
    dir6 = (dq[0] << 4) | (dq[1] << 2) | dq[2]
    dq4 = [_quantize((d3[a] * 0.5 + 0.5) * 16.0, 15.0) for a in (1, 2)]
    dfine6 = ((dq4[0] & 3) << 4) | dq4[1]
    m = _spread3(q[0]) | (_spread3(q[1]) << 1) | (_spread3(q[2]) << 2)
    key = ((dir6 << 26) | ((m >> 15) << 14) | (dfine6 << 8)
           | ((m >> 7) & 0xFF))
    key = key.clamp_max(DEAD_KEY - 1)
    if alive is not None:
        key = torch.where(alive, key, DEAD_KEY)
    return key


def ray_sort_keys(origin, direction, lo, hi, alive=None) -> torch.Tensor:
    """:func:`ray_sort_keys_soa` of (R, 3) origins and directions."""
    return ray_sort_keys_soa(tuple(origin[..., a] for a in range(3)),
                             tuple(direction[..., a] for a in range(3)),
                             lo, hi, alive)


def sort_keys_i32_plain(o3, d3, lo, hi, alive=None) -> torch.Tensor:
    """Plain version of the G2 kernel: :func:`ray_sort_keys_soa` mapped to
    int32 as ``key - 2^31``, which keeps the order; ``DEAD_KEY`` becomes
    ``DEAD_KEY32``."""
    return (ray_sort_keys_soa(o3, d3, lo, hi, alive) - 2**31).to(torch.int32)


def _sort_keys_cuda(o3, d3, lo, hi, alive):
    dev = o3[0].device
    R = o3[0].shape[0]
    for name, x in zip(("ox", "oy", "oz", "dx", "dy", "dz"), (*o3, *d3)):
        _kernels.require(x, name, torch.float32, dev, R)
    if alive is not None:
        _kernels.require(alive, "alive", torch.bool, dev, R)
    f32 = np.float32
    ext = [max(f32(hi[a] - lo[a]), f32(1e-6)) for a in range(3)]
    # ``/ ext``: PyTorch's CUDA division by a Python number is a product
    # with its float32 reciprocal
    lo_c = (ctypes.c_float * 3)(*(float(f32(lo[a])) for a in range(3)))
    inv = (ctypes.c_float * 3)(*(float(f32(1.0) / e) for e in ext))
    keys = torch.empty(R, dtype=torch.int32, device=dev)
    _kernels.launch("oglrt_sort_keys", "sort_keys", dev,
                    *(x.data_ptr() for x in (*o3, *d3)),
                    None if alive is None else alive.data_ptr(), lo_c, inv,
                    keys.data_ptr(), R)
    return keys


def sort_keys(o3, d3, lo, hi, alive=None) -> torch.Tensor:
    """int32 coherence keys (G2): the uint32 key of
    :func:`ray_sort_keys_soa` minus 2^31, so a stable sort orders rays as
    the uint32 keys do and dead rays (``DEAD_KEY32``) sort last.  CUDA
    columns (contiguous float32) launch the kernel of
    ``csrc/sort_keys.cu``; CPU columns run :func:`sort_keys_i32_plain`."""
    if o3[0].is_cuda:
        return _sort_keys_cuda(o3, d3, lo, hi, alive)
    return sort_keys_i32_plain(o3, d3, lo, hi, alive)
