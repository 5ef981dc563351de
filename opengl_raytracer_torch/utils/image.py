"""Image output & comparison utilities.

The reference displays by blitting the RGBA32F accumulation FBO to the
8-bit default framebuffer (clamped unorm conversion, main.py:397-399) and
saves a PNG on exit (main.py:432-439).  Here: explicit conversion
(:func:`to_uint8`, and on the App's display path :class:`Display`, which
converts on the frame's device), and a PNG encoder and decoder on the
standard library (``zlib``, ``struct``) and NumPy, so writing an image
needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from opengl_raytracer_torch.ops import display as _display
from opengl_raytracer_torch.utils import profiling

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Linear float image -> 8-bit, GL-style clamp + round."""
    return np.round(np.clip(np.asarray(img), 0.0, 1.0) * 255.0).astype(np.uint8)


class Display:
    """The App's display path: each finished sweep converted to 8 bits
    where it was rendered and handed to a sink one frame later.

    :meth:`start` converts ``accum`` (``ops/display.py:to_uint8``, one
    launch on the step's stream) into one of two device buffers, then
    copies that buffer on a copy stream into one of two pinned host
    buffers, so the copy overlaps the next sweep; span
    ``display.convert``.  :meth:`present` waits for that copy alone and
    calls ``sink(image, frame_count)`` with the (H, W, 3) uint8 host
    buffer.  A buffer handed to a sink stays unchanged until the next
    :meth:`present`: :meth:`start` writes the other pair, and on the card
    a device buffer is rewritten only after the copy that read it.  On
    the CPU the conversion is the plain version and the copy a copy."""

    def __init__(self, height: int, width: int, device):
        device = torch.device(device)
        shape = (height, width, 3)
        self.cuda = device.type == "cuda"
        self._dev = [torch.empty(shape, dtype=torch.uint8, device=device)
                     for _ in range(2)]
        self._host = [torch.empty(shape, dtype=torch.uint8,
                                  pin_memory=self.cuda) for _ in range(2)]
        if self.cuda:
            self._copy_stream = torch.cuda.Stream(device)
            self._converted = [torch.cuda.Event() for _ in range(2)]
            self._copied = [torch.cuda.Event() for _ in range(2)]
        self._pending: tuple[int, int] | None = None  # (slot, frame count)
        self._held: int | None = None  # the slot the last sink was handed

    def start(self, accum: torch.Tensor, frame_count: int) -> None:
        """Convert ``accum`` and start its copy to the host; the next
        :meth:`present` shows it, as frame ``frame_count``."""
        with profiling.per_step("display.convert"):
            i = 1 if self._held == 0 else 0
            if not self.cuda:
                _display.to_uint8(accum, self._dev[i])
                self._host[i].copy_(self._dev[i])
            else:
                main = torch.cuda.current_stream(accum.device)
                main.wait_event(self._copied[i])  # the last copy of dev[i]
                _display.to_uint8(accum, self._dev[i])
                self._converted[i].record(main)
                self._copy_stream.wait_event(self._converted[i])
                with torch.cuda.stream(self._copy_stream):
                    self._host[i].copy_(self._dev[i], non_blocking=True)
                self._copied[i].record(self._copy_stream)
            self._pending = (i, frame_count)

    def present(self, sink) -> bool:
        """Hand the last started frame to ``sink`` once its copy is done;
        False where no frame was started since the last present."""
        if self._pending is None:
            return False
        i, frame_count = self._pending
        self._pending = None
        if self.cuda:
            self._copied[i].synchronize()
        self._held = i
        sink(self._host[i], frame_count)
        profiling.count("app.presented")
        return True


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_png(path: str, img: np.ndarray) -> None:
    """Save an (H, W, 3) float or uint8 image (top row first) as an 8-bit
    RGB, non-interlaced PNG whose rows all use filter type 0 (None)."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {arr.shape}")
    h, w, _ = arr.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # column 0: filter type 0
    rows[:, 1:] = arr.reshape(h, 3 * w)
    # bit depth 8, colour type 2 (RGB), deflate, adaptive filtering, no
    # interlace
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (types 0-4) of an 8-bit image."""
    stride = w * bpp
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    data = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = int(data[y, 0]), data[y, 1:].astype(np.int32)
        if ftype == 0:  # None
            cur = line
        elif ftype == 1:  # Sub: a running sum along each channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: left to right, byte by byte
            ln, up, res = line.tolist(), prev.tolist(), [0] * stride
            for x in range(stride):
                a = res[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                res[x] = (ln[x] + pred) & 0xFF
            cur = np.asarray(res, np.int32)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def load_png(path: str) -> np.ndarray:
    """Load an 8-bit RGB or RGBA, non-interlaced PNG as (H, W, 3) float32
    in [0, 1] (alpha dropped)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path!r} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path!r} has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    channels = {2: 3, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path!r}: only 8-bit RGB/RGBA non-interlaced PNGs "
                         f"are read (bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w, channels)
    img = pix.reshape(h, w, channels)[:, :, :3]
    return img.astype(np.float32) / 255.0


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square error between two float images."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
