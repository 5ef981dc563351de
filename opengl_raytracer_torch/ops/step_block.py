"""The step block: every value a tile step takes that changes from step to
step, in one (32,) int32 tensor on the step's device.

The JAX package jits its tile step with the frame number, the tile, the
camera, the sky brightness, the jitter and ``lambertian`` as traced
arguments (``opengl_raytracer_tpu/renderer.py:467-500``), so one
executable serves every step.  The port's counterpart is one CUDA graph of
the step, which must not bake any of those values in: they live here, and
the kernels of the step (G1 ray front, K2 shade, G6 band fold) read them
from the block when they run.  On the CPU the block is a CPU tensor whose
values the plain versions read (:func:`values`).

Layout, 32-bit words (``csrc/step_block.cuh`` is the same struct):

====== ===========================================================
0-1    frame number (int64)
2-3    address of the (H, W, 3) float32 ``accum`` G6 folds into
4-8    col0, py0, dx0, dy0, row0: the band window (``band_window``)
9      lambertian (0 or 1)
10-21  camera pos, right, up, forward (float32)
22-24  sky colour: ``SKY_COLOR * sky_brightness`` (float32)
25     emission scale: 2.0 when lambertian, else 1.0
26     jitter amount (float32)
27-31  padding
====== ===========================================================

:func:`write` fills a block: on a CUDA block one launch of
``csrc/step_block.cu`` whose values travel as its by-value argument (so
the host may pack the next step's values at once), counted as
``step_block``; on a CPU block a copy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opengl_raytracer_torch.ops import _kernels
from opengl_raytracer_torch.ops.camera import Camera
from opengl_raytracer_torch.utils.config import SKY_COLOR

WORDS = 32


class StepValues(NamedTuple):
    """A block's values, read back (:func:`values`)."""

    frame: int
    accum: int
    col0: int
    py0: int
    dx0: int
    dy0: int
    row0: int
    lambertian: bool
    camera: Camera
    sky: tuple  # 3 floats
    em_scale: float
    jitter: float


def new(device) -> torch.Tensor:
    """A zeroed block on ``device``."""
    return torch.zeros(WORDS, dtype=torch.int32, device=device)


def pack(frame: int, window, camera: Camera, sky_brightness: float,
         jitter: float, lambertian: bool, accum: int = 0) -> np.ndarray:
    """The block's (32,) int32 words: ``window`` is (col0, py0, dx0, dy0,
    row0) and ``accum`` the accumulation buffer's address (0 where no
    fold reads it)."""
    w = np.zeros(WORDS, np.int32)
    w[0:4] = np.array([frame, accum], np.int64).view(np.int32)
    w[4:9] = window
    w[9] = int(bool(lambertian))
    f32 = np.float32
    sky = np.asarray(SKY_COLOR, f32) * f32(sky_brightness)
    floats = np.concatenate([camera.pos, camera.right, camera.up,
                             camera.forward, sky,
                             [2.0 if lambertian else 1.0, jitter]]).astype(f32)
    w[10:27] = floats.view(np.int32)
    return w


def write_plain(block: torch.Tensor, words: np.ndarray) -> None:
    """Plain version of the write: a copy of the words."""
    block.copy_(torch.from_numpy(words).to(block.device))


def _write_cuda(block: torch.Tensor, words: np.ndarray) -> None:
    _kernels.require(block, "block", torch.int32, block.device, WORDS)
    w = np.ascontiguousarray(words, np.int32)
    if w.shape != (WORDS,):
        raise ValueError(f"a block holds {WORDS} words, got {w.shape}")
    _kernels.launch("oglrt_write_block", "step_block", block.device,
                    block.data_ptr(), w.ctypes.data)


def write(block: torch.Tensor, words: np.ndarray) -> None:
    """Write ``words`` (:func:`pack`) into ``block``: one launch on a CUDA
    block, a copy on a CPU one."""
    if block.is_cuda:
        _write_cuda(block, words)
    else:
        write_plain(block, words)


def values(block: torch.Tensor) -> StepValues:
    """The block's values as Python numbers (a device-to-host copy of a
    CUDA block): what the plain versions read."""
    w = block.detach().cpu().numpy().astype(np.int32)
    frame, accum = (int(x) for x in w[0:4].view(np.int64))
    col0, py0, dx0, dy0, row0 = (int(x) for x in w[4:9])
    f = w[10:27].view(np.float32)
    camera = Camera(pos=f[0:3].copy(), right=f[3:6].copy(), up=f[6:9].copy(),
                    forward=f[9:12].copy())
    return StepValues(frame=frame, accum=accum, col0=col0, py0=py0, dx0=dx0,
                      dy0=dy0, row0=row0, lambertian=bool(w[9]),
                      camera=camera, sky=tuple(float(x) for x in f[12:15]),
                      em_scale=float(f[15]), jitter=float(f[16]))


def target(words: np.ndarray) -> tuple:
    """(accum's address, col0, row0) of a block's words: where G6 folds."""
    w = np.asarray(words, np.int32)
    return int(w[2:4].view(np.int64)[0]), int(w[4]), int(w[8])


def frame_tensor(block: torch.Tensor) -> torch.Tensor:
    """The frame number as a (1,) int64 view of the block."""
    return block[0:2].view(torch.int64)
