"""G1: the per-pixel ray front.

:func:`ray_front` gives each ray of a tile step its pixel, frame number,
primary ray and RNG state, as the JAX renderer's ``_tile_step`` and
``render_pixels`` do ahead of ``trace``
(``opengl_raytracer_tpu/renderer.py:162-199``, ``:300-353``;
fragment.glsl:376-407): ray ``g`` of a step is pixel ``g mod n_band`` of
the band, row-major from its bottom GL row or, for the ``"packet"``
traversal, in 8x16 pixel blocks (:func:`band_xy`), at frame ``frame + g //
n_band`` (``frames_per_step`` copies of the band); then the seed
``x*1973 ^ y*9277 ^ frame*1664525``, three warm-up draws, uv at the pixel
centre, the angle-linear direction, two jitter draws and the normalize,
and origin columns at the camera.  The band window, the frame number, the
camera and the jitter come from the step block (``ops/step_block.py``).
On a CUDA block it launches the kernel of ``csrc/ray_front.cu``; on a CPU
block it runs :func:`ray_front_plain`, the same math as torch ops
(:func:`pixel_front`, ``ops/rng.py``, ``ops/camera.py``).  The two agree
bit for bit on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from opengl_raytracer_torch.ops import _kernels, rng, step_block
from opengl_raytracer_torch.ops.camera import (Camera, angle_linear_constants,
                                               pixel_uv, ray_dirs_soa)

FRONT_DRAWS = 5  # LCG steps from the pixel seed: 3 warm-ups, 2 jitter draws


def pixel_front(px, py, frame_number, camera: Camera, width: int,
                height: int, aspect, jitter_amount: float):
    """The front's math for given pixels: ``px``/``py`` int64 (R,) (py in
    GL convention, 0 = bottom row) at ``frame_number`` (an int or an (R,)
    int64 tensor) in a ``width`` x ``height`` frame; ``aspect`` None means
    width / height.  Returns (origin, direction, seed), origin and
    direction 3-tuples of (R,) float32 columns, seed (R,) int64 uint32
    states after the three warm-ups and the two jitter draws."""
    seed = rng.seed_pixels(px, py, frame_number)
    seed = rng.warmup(seed, 3)

    u, v = pixel_uv(px, py, width, height)
    d = ray_dirs_soa(camera, u, v, width, height, aspect=aspect)

    # Anti-alias jitter (fragment.glsl:398-400).
    jit = float(np.float32(jitter_amount))
    seed, r1 = rng.random_value(seed)
    seed, r2 = rng.random_value(seed)
    d = tuple(
        d[a] + (float(camera.right[a]) * r1 + float(camera.up[a]) * r2) * jit
        for a in range(3))
    d_len = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    d = tuple(d[a] / d_len for a in range(3))

    origin = tuple(torch.full_like(d[0], float(camera.pos[a]))
                   for a in range(3))
    return origin, d, seed


BLOCK_H, BLOCK_W = 8, 16  # the packet traversal's pixel blocks


def band_xy(j, tw: int, blocks: bool = False):
    """(column, row) from the band's bottom-left of its pixel ``j`` (an
    int64 tensor), ``tw`` a row: row-major, or with ``blocks`` in 8x16
    blocks of 128 pixels, block ``b = j // 128`` the ``b mod (tw / 16)``-th
    of the ``b // (tw / 16)``-th band of 8 rows, in row-major order inside
    (the JAX renderer's ``to_blocks``, ``renderer.py:322-336``)."""
    if not blocks:
        return j % tw, j // tw
    b, k = j // (BLOCK_H * BLOCK_W), j % (BLOCK_H * BLOCK_W)
    nbx = tw // BLOCK_W
    return b % nbx * BLOCK_W + k % BLOCK_W, b // nbx * BLOCK_H + k // BLOCK_W


def check_band(n_band: int, tw: int, blocks: bool) -> None:
    """A band of ``n_band`` pixels in rows of ``tw``: whole rows, and with
    ``blocks`` whole 8x16 blocks."""
    if tw < 1 or n_band < tw or n_band % tw or (blocks and (
            tw % BLOCK_W or (n_band // tw) % BLOCK_H)):
        raise ValueError(f"a band of {n_band} pixels in rows of {tw}"
                         + (" in 8x16 blocks" if blocks else ""))


def band_pixels(col0: int, py0: int, frame: int, base: int, n: int,
                n_rays: int, n_band: int, tw: int, device, index=None,
                blocks: bool = False):
    """(px, py, frame numbers) int64 (n,) of rays ``base .. base + n - 1``
    of a step: ray ``g`` is pixel ``j = g mod n_band`` of the band whose
    bottom-left pixel is (col0, py0), ``tw`` a row (:func:`band_xy`:
    row-major, px = col0 + j mod tw, py = py0 + j // tw, or in 8x16
    blocks), at frame ``frame + g // n_band``; rays at or past ``n_rays``
    pad a chunk as pixel (0, 0) at ``frame``.  ``index`` (an (n,) int
    tensor) names the rays ``base + index`` instead."""
    g = (torch.arange(base, base + n, dtype=torch.int64, device=device)
         if index is None else base + index.to(torch.int64))
    valid = g < n_rays
    jx, jy = band_xy(g % n_band, tw, blocks)
    px = torch.where(valid, col0 + jx, 0)
    py = torch.where(valid, py0 + jy, 0)
    return px, py, frame + torch.where(valid, g // n_band, 0)


def ray_front_plain(block, base: int, n: int, n_rays: int, n_band: int,
                    tw: int, width: int, height: int, aspect,
                    blocks: bool = False):
    """Plain torch version: the block's values read back, the rays' pixels
    (:func:`band_pixels`) and :func:`pixel_front`."""
    v = step_block.values(block)
    px, py, frames = band_pixels(v.col0, v.py0, v.frame, base, n, n_rays,
                                 n_band, tw, block.device, blocks=blocks)
    return pixel_front(px, py, frames, v.camera, width, height, aspect,
                       v.jitter)


def _ray_front_cuda(block, base: int, n: int, n_rays: int, n_band: int,
                    tw: int, width: int, height: int, aspect,
                    blocks: bool = False):
    dev = block.device
    _kernels.require(block, "block", torch.int32, dev, step_block.WORDS)
    f32 = np.float32
    # (px + 0.5) / width: PyTorch's CUDA division by a Python number is a
    # product with its float32 reciprocal
    inv_w, inv_h = float(f32(1.0) / f32(width)), float(f32(1.0) / f32(height))
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    seed = torch.empty(n, dtype=torch.int64, device=dev)
    _kernels.launch(
        "oglrt_ray_front", "ray_front", dev, block.data_ptr(), base, n_rays,
        n_band, tw, int(blocks),
        *angle_linear_constants(width, height, aspect=aspect),
        inv_w, inv_h, out.data_ptr(), seed.data_ptr(), n)
    return (out[0], out[1], out[2]), (out[3], out[4], out[5]), seed


def ray_front(block, base: int, n: int, n_rays: int, n_band: int, tw: int,
              width: int, height: int, aspect, blocks: bool = False):
    """Primary rays of rays ``base .. base + n - 1`` of a step of
    ``n_rays`` rays over a band of ``n_band`` pixels, ``tw`` a row (with
    ``blocks``, taken in 8x16 pixel blocks), in a ``width`` x ``height``
    frame (``aspect`` None: width / height), with the window, frame
    number, camera and jitter of ``block``.  Returns (origin, direction,
    seed) as :func:`pixel_front` does."""
    check_band(n_band, tw, blocks)
    if n < 0:
        raise ValueError(f"n={n} rays")
    args = (block, base, n, n_rays, n_band, tw, width, height, aspect,
            blocks)
    return _ray_front_cuda(*args) if block.is_cuda else ray_front_plain(*args)
