"""G1: the per-pixel ray front.

:func:`ray_front` gives each pixel's primary ray and RNG state, as the
JAX renderer's ``render_pixels`` does ahead of ``trace``
(``opengl_raytracer_tpu/renderer.py:162-199``; fragment.glsl:376-407): the
seed ``x*1973 ^ y*9277 ^ frame*1664525``, three warm-up draws, uv at the
pixel centre, the angle-linear direction, two jitter draws and the
normalize, and origin columns at the camera.  On CUDA tensors it launches
the kernel of ``csrc/ray_front.cu``; on CPU tensors it runs
:func:`ray_front_plain`, the same math as torch ops (``ops/rng.py``,
``ops/camera.py``).  The two agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opengl_raytracer_torch.ops import _kernels, rng
from opengl_raytracer_torch.ops.camera import (Camera, angle_linear_constants,
                                               pixel_uv, ray_dirs_soa)


def ray_front_plain(px, py, frame_number, camera: Camera, width: int,
                    height: int, aspect, jitter_amount: float):
    """Plain torch version: returns (origin, direction, seed), origin and
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


def _ray_front_cuda(px, py, frame_number, camera: Camera, width: int,
                    height: int, aspect, jitter_amount: float):
    dev = px.device
    R = px.shape[0]
    _kernels.require(px, "px", torch.int64, dev, R)
    _kernels.require(py, "py", torch.int64, dev, R)
    frames, frame_term = None, 0
    if isinstance(frame_number, torch.Tensor):
        _kernels.require(frame_number, "frame_number", torch.int64, dev, R)
        frames = frame_number.data_ptr()
    else:
        frame_term = ((int(frame_number) & rng.MASK32) * 1664525) & rng.MASK32
    cam = (ctypes.c_float * 12)(*(float(x) for x in np.concatenate(
        [camera.pos, camera.right, camera.up, camera.forward])
        .astype(np.float32)))
    f32 = np.float32
    # (px + 0.5) / width: PyTorch's CUDA division by a Python number is a
    # product with its float32 reciprocal
    inv_w, inv_h = float(f32(1.0) / f32(width)), float(f32(1.0) / f32(height))
    out = torch.empty((6, R), dtype=torch.float32, device=dev)
    seed = torch.empty(R, dtype=torch.int64, device=dev)
    _kernels.launch(
        "oglrt_ray_front", "ray_front", dev, px.data_ptr(), py.data_ptr(),
        frames, frame_term, cam,
        *angle_linear_constants(width, height, aspect=aspect), inv_w, inv_h,
        float(f32(jitter_amount)), out.data_ptr(), seed.data_ptr(), R)
    return (out[0], out[1], out[2]), (out[3], out[4], out[5]), seed


def ray_front(px, py, frame_number, camera: Camera, width: int, height: int,
              aspect, jitter_amount: float):
    """Primary rays of the pixels ``px``/``py`` (int64 (R,), py in GL
    convention, 0 = bottom row) at ``frame_number`` (an int, or an (R,)
    int64 tensor under frame batching) in a ``width`` x ``height`` frame;
    ``aspect`` None means width / height.  Returns (origin, direction,
    seed) as :func:`ray_front_plain` does."""
    args = (px, py, frame_number, camera, width, height, aspect,
            jitter_amount)
    return _ray_front_cuda(*args) if px.is_cuda else ray_front_plain(*args)
