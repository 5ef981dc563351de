"""The App's display conversion: a linear float frame to 8 bits.

:func:`to_uint8` writes ``utils/image.to_uint8`` of an (H, W, 3) float32
frame into an (H, W, 3) uint8 tensor on the frame's device: clamp to
[0, 1], multiply by 255 in float32, round half to even, convert.  On a
CUDA tensor it is one launch of ``csrc/to_uint8.cu`` on the current
stream, counted as ``to_uint8``; on a CPU tensor it runs
:func:`to_uint8_plain`.  The two agree with ``to_uint8`` bit for bit on
finite values.
"""

from __future__ import annotations

import torch

from opengl_raytracer_torch.ops import _kernels


def to_uint8_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain torch version: ``round(clamp(img, 0, 1) * 255)`` as uint8
    (``torch.round`` rounds half to even, as ``np.round``)."""
    return torch.round(img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def _to_uint8_cuda(img: torch.Tensor, out: torch.Tensor) -> None:
    if img.data_ptr() % 16 or out.data_ptr() % 4:
        raise ValueError("the frame must be 16-byte aligned and the output "
                         "4-byte aligned")
    n = img.numel()
    _kernels.launch("oglrt_to_uint8", "to_uint8", img.device, img.data_ptr(),
                    out.data_ptr(), n, kernels=1 + (n % 4 != 0))


def to_uint8(img: torch.Tensor, out: torch.Tensor) -> None:
    """Convert ``img`` ((H, W, 3) float32, contiguous) into ``out`` ((H, W,
    3) uint8, contiguous, on ``img``'s device)."""
    dev = img.device
    _kernels.require(img, "frame", torch.float32, dev)
    _kernels.require(out, "out", torch.uint8, dev)
    if img.dim() != 3 or img.shape[2] != 3 or out.shape != img.shape:
        raise ValueError(f"expected an (H, W, 3) frame and an output of its "
                         f"shape, got {tuple(img.shape)} and "
                         f"{tuple(out.shape)}")
    if img.is_cuda:
        _to_uint8_cuda(img, out)
    else:
        out.copy_(to_uint8_plain(img))
