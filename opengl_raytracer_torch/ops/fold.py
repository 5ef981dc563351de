"""G6: the band fold.

:func:`fold_band` folds a tile step's colours into the accumulation in
place, as the JAX tile step merges its band
(``opengl_raytracer_tpu/renderer.py:367-391``; fragment.glsl:409-414):
the sum of the step's ``n_frames`` colour sets (``frames_per_step``
copies of the band, added one after another), flipped from GL rows to
``accum``'s top-row-first rows, then ``(prev * fc + sum) / (fc +
weight)`` wherever the remainder tile's mask is set, with ``fc`` the frame
count as float32.  The colours of each band copy are the band's pixels
row-major from its bottom GL row or, for the ``"packet"`` traversal, in
the 8x16 blocks G1 gave the rays (``front.band_xy``; the JAX step's
inverse of ``to_blocks``, ``renderer.py:369-374``).  The window, the
frame count and, on the card, ``accum``'s address come from the step
block (``ops/step_block.py``).

On a CUDA block it is one launch of ``csrc/band_fold.cu``, which folds
into the buffer whose address the block holds (``step_block.pack``'s
``accum``, the caller's ``accum``), so one captured step serves a new
buffer after ``Renderer.reset`` or a checkpoint resume; ``accum`` itself
is checked for its shape.  On a CPU block it runs :func:`fold_plain`.  The
two agree bit for bit on the card: the divisor is a float32 tensor in both
(IEEE division, as the JAX fold's), not a Python number, which PyTorch's
CUDA division would turn into a product with its reciprocal.
"""

from __future__ import annotations

import torch

from opengl_raytracer_torch.ops import _kernels, step_block
from opengl_raytracer_torch.ops.front import BLOCK_H, BLOCK_W, check_band


def fold_plain(accum, colors, block, tw: int, th: int, n_frames: int,
               weight: int, blocks: bool = False) -> None:
    """Plain torch version of the fold (see the module docstring)."""
    v = step_block.values(block)
    n_band = tw * th
    if blocks:
        cols = [c[:n_frames * n_band].reshape(
            n_frames, th // BLOCK_H, tw // BLOCK_W, BLOCK_H, BLOCK_W)
            .permute(0, 1, 3, 2, 4).reshape(n_frames, th, tw)
            for c in colors]
    else:
        cols = [c[:n_frames * n_band].reshape(n_frames, th, tw)
                for c in colors]
    total = [c[0] for c in cols]
    for f in range(1, n_frames):
        total = [total[a] + cols[a][f] for a in range(3)]
    # GL py ascends bottom-up; accum rows descend top-down.
    tile = torch.stack(total, dim=-1).flip(0)
    dev = accum.device
    valid = ((torch.arange(tw, device=dev)[None, :] >= v.dx0)
             & (torch.arange(th, device=dev)[:, None] >= v.dy0))
    mask = valid.flip(0)[:, :, None]
    prev = accum[v.row0:v.row0 + th, v.col0:v.col0 + tw]
    fc = step_block.frame_tensor(block).to(torch.float32)
    prev.copy_(torch.where(mask, (prev * fc + tile) / (fc + weight), prev))


def _fold_cuda(accum, colors, block, tw: int, th: int, n_frames: int,
               weight: int, blocks: bool = False) -> None:
    dev = block.device
    req = _kernels.require
    req(block, "block", torch.int32, dev, step_block.WORDS)
    req(accum, "accum", torch.float32, dev)
    if accum.dim() != 3 or accum.shape[2] != 3 or accum.shape[0] < th \
            or accum.shape[1] < tw:
        raise ValueError(f"accum must be (H, W, 3) holding a {th} x {tw} "
                         f"band, got {tuple(accum.shape)}")
    n = n_frames * tw * th
    for a, c in enumerate(colors):
        req(c, f"color {a}", torch.float32, dev)
        if c.dim() != 1 or c.shape[0] < n:
            raise ValueError(f"color {a} must be (R,) with R >= {n}, got "
                             f"{tuple(c.shape)}")
    _kernels.launch("oglrt_band_fold", "band_fold", dev, block.data_ptr(),
                    *(c.data_ptr() for c in colors), tw * th, tw, th,
                    n_frames, float(weight), accum.shape[1], int(blocks))


def check_target(accum, words, tw: int, th: int) -> None:
    """Host check of a block's ``words`` (``step_block.pack``) before they
    are written for a fold of a ``th`` x ``tw`` band into ``accum``: the
    address is ``accum``'s and the window (col0, row0) lies inside it.  A
    CUDA fold writes at the block's address, which :func:`fold_band` sees
    only on the device."""
    address, col0, row0 = step_block.target(words)
    if address != accum.data_ptr():
        raise ValueError(f"the block folds into {address:#x}, not into "
                         f"accum at {accum.data_ptr():#x}")
    if (row0 < 0 or col0 < 0 or row0 + th > accum.shape[0]
            or col0 + tw > accum.shape[1]):
        raise ValueError(f"a {th} x {tw} band at row {row0}, column {col0} "
                         f"leaves accum {tuple(accum.shape)}")


def fold_band(accum, colors, block, tw: int, th: int, n_frames: int,
              weight: int, blocks: bool = False) -> None:
    """Fold ``colors`` (3 float32 columns of ``n_frames`` x ``tw * th``
    rays, each copy of the band row-major from its bottom GL row, or with
    ``blocks`` in 8x16 pixel blocks) into ``accum`` ((H, W, 3) float32, top
    row first) in place, with running mean weight ``weight``, at the window
    and frame count of ``block``.  On the card the kernel folds into the
    buffer at the block's ``accum`` address, which must be ``accum``'s."""
    if n_frames < 1 or tw < 1 or th < 1:
        raise ValueError(f"a {th} x {tw} band of {n_frames} frames")
    check_band(tw * th, tw, blocks)
    args = (accum, colors, block, tw, th, n_frames, weight, blocks)
    return _fold_cuda(*args) if block.is_cuda else fold_plain(*args)
