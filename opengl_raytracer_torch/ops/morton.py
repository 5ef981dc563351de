"""Ray-coherence sort keys (direction cell + Morton position), as uint32
values held in int64 tensors (see ops/rng.py for why int64).

Sorting rays by these keys before every bounce segment groups rays that
start near each other and fly the same way.  Dead rays get the reserved
sentinel ``0xFFFFFFFF`` and sort to the tail; live keys are clamped below
it, so ``alive`` can be re-derived from a sorted key
(``opengl_raytracer_tpu/ops/morton.py:47-78``).
"""

from __future__ import annotations

import numpy as np
import torch

DEAD_KEY = 0xFFFFFFFF


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so bit i lands at position 3i."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


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
