"""Image output & comparison utilities.

The reference displays by blitting the RGBA32F accumulation FBO to the
8-bit default framebuffer (clamped unorm conversion, main.py:397-399) and
saves a PNG on exit (main.py:432-439).  Here: explicit conversion + PIL.
"""

from __future__ import annotations

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Linear float image -> 8-bit, GL-style clamp + round."""
    return np.round(np.clip(np.asarray(img), 0.0, 1.0) * 255.0).astype(np.uint8)


def save_png(path: str, img: np.ndarray) -> None:
    """Save (H, W, 3) float or uint8 image (top row first) as PNG."""
    from PIL import Image

    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    Image.fromarray(arr, mode="RGB").save(path)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square error between two float images."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
