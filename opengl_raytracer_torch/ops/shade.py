"""K2: fused shade / scatter / bounce-state update, one pass per bounce.

:func:`shade_update` is the port of
``opengl_raytracer_tpu/ops/shade.py:shade_update``, for every traversal:
it takes the shading table and the index column as arguments
(``intersect.shading_table``), ``(sh_slot, slot)`` after the sub-block
traversal and ``(sh_abc, tri)`` after every other one.  On CUDA tensors it
launches the kernel of ``csrc/shade.cu``, which also does the material row
gather ``table[clip(index)]`` and the three RNG draws that the JAX wrapper
computes outside its kernel.  On CPU tensors it runs :func:`_shade_plain`:
the integrator's unfused formulas (``integrator.py:281-311`` of the JAX
package): finalize_hit, scatter, then the state update.  So on the card
the kernel replaces, after the brute, BVH and wide-BVH traversals, the
same unfused ops it replaces after the sub-block one.  Seeds and alive
flags agree exactly; floats agree to mul+add contraction rounding.
"""

from __future__ import annotations

import torch

from opengl_raytracer_torch.ops import _kernels, step_block
from opengl_raytracer_torch.ops.integrator import scatter_soa
from opengl_raytracer_torch.ops.intersect import finalize_hit_soa


def _shade_plain(table, index, nearest, o3, d3, rc3, inc3, alive, seed,
                 block):
    v = step_block.values(block)
    sky_color, emission_scale, lambertian = v.sky, v.em_scale, v.lambertian
    hit = finalize_hit_soa(table, index, o3, d3, nearest)
    seed_h, new_dir = scatter_soa(seed, hit.normal, d3, hit.roughness,
                                  lambertian)
    was_hit = alive & hit.did_hit
    was_miss = alive & ~hit.did_hit
    em = hit.emission * emission_scale
    zero = torch.zeros_like(hit.t)
    inc = tuple(
        inc3[a]
        + torch.where(was_hit, hit.emission_color[a] * em * rc3[a], zero)
        + torch.where(was_miss, sky_color[a], zero)
        for a in range(3))
    rc = tuple(torch.where(was_hit, rc3[a] * hit.color[a], rc3[a])
               for a in range(3))
    o = tuple(torch.where(was_hit, hit.point[a] + hit.normal[a] * 1e-4, o3[a])
              for a in range(3))
    d = tuple(torch.where(was_hit, new_dir[a], d3[a]) for a in range(3))
    seed = torch.where(was_hit, seed_h, seed)
    alive = was_hit & ~(hit.emission > 0.0)
    return o, d, rc, inc, alive, seed


def _shade_cuda(table, index, nearest, o3, d3, rc3, inc3, alive, seed,
                block):
    dev = seed.device
    R = seed.shape[0]
    req = _kernels.require
    cols = (nearest.t, nearest.u, nearest.v, *o3, *d3, *rc3, *inc3)
    for k, x in enumerate(cols):
        req(x, f"float column {k}", torch.float32, dev, R)
    req(index, "index", torch.int32, dev, R)
    req(alive, "alive", torch.bool, dev, R)
    req(seed, "seed", torch.int64, dev, R)
    req(table, "table", torch.float32, dev)
    req(block, "block", torch.int32, dev, step_block.WORDS)
    if table.dim() != 2 or table.shape[1] != 24 or table.shape[0] == 0:
        raise ValueError(f"table must be (S, 24) with S > 0, got "
                         f"{tuple(table.shape)}")
    out = torch.empty((12, R), dtype=torch.float32, device=dev)
    alive_out = torch.empty(R, dtype=torch.bool, device=dev)
    seed_out = torch.empty(R, dtype=torch.int64, device=dev)
    _kernels.launch(
        "oglrt_shade", "shade", dev,
        table.data_ptr(), table.shape[0], index.data_ptr(),
        *(x.data_ptr() for x in cols),
        alive.data_ptr(), seed.data_ptr(), block.data_ptr(),
        *(out[k].data_ptr() for k in range(12)),
        alive_out.data_ptr(), seed_out.data_ptr(), R)
    o, d, rc, inc = (tuple(out[3 * g + a] for a in range(3))
                     for g in range(4))
    return o, d, rc, inc, alive_out, seed_out


def shade_update(table, index, nearest, o3, d3, rc3, inc3, alive, seed,
                 block):
    """Fused finalize + scatter + state update for one bounce.

    ``table`` is the (S, 24) float32 shading table and ``index`` the (R,)
    int32 column that picks each ray's row, clamped into the table.  vec3
    state is 3-tuples of contiguous (R,) float32 columns; ``alive`` is
    (R,) bool, ``seed`` (R,) int64 uint32 states, ``nearest`` the
    traversal's :class:`Nearest`.  The sky colour, the emission scale and
    ``lambertian`` are the step block's (``ops/step_block.py``), which the
    kernel reads when it runs.  Returns (o3', d3', rc3', inc3', alive',
    seed')."""
    args = (table, index, nearest, o3, d3, rc3, inc3, alive, seed, block)
    return _shade_cuda(*args) if seed.is_cuda else _shade_plain(*args)
