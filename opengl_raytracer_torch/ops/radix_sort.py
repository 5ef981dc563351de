"""G10: the integrator's ray sort, a stable LSD radix sort of int32 keys.

``sort_rays(keys)`` returns ``(keys_s, perm)``, both int32: the pair
``torch.sort(keys, stable=True)`` returns, with the permutation as int32,
bit for bit (a stable sort's permutation is fixed by the keys alone).  It
replaces the sorts of ``opengl_raytracer_tpu/ops/integrator.py:209-268``,
which the port ran as ``torch.sort`` until G10.

On CUDA tensors it launches ``csrc/radix_sort.cu`` (one histogram launch
and four passes of 8-bit digits, the onesweep design; the source says what
bounds it) and counts those 5 launches under
``launch_counts["radix_sort"]``; the tile size follows ``n``
(:func:`design`).  On CPU tensors it is ``torch.sort`` itself, the plain
version of G10.
"""

from __future__ import annotations

import torch

from opengl_raytracer_torch.ops import _kernels

# csrc/radix_sort.cu's constants
DIGITS = 256  # an 8-bit digit's values
PASSES = 4  # one a digit of the 32-bit key
BLOCK = 256  # threads of a pass block
HIST_KEYS = 8192  # keys a histogram block, and at
MAX_HIST_BLOCKS = 128  # most this many blocks
GROUP = 16  # tiles a group of the look-back's second level
MAX_KEYS = 2**30 - 2**16  # the look-back words hold counts below 2^30


def design(n: int) -> int:
    """Keys a pass thread for ``n`` keys: tiles of 4,096 keys from
    1,048,576 keys up (a 1080p frame: 507 tiles), else of 2,048 (a
    quarter frame: 254), so that every SM has tiles in flight.  On an H100
    a frame's keys sort in 0.137 ms with tiles of 4,096 and 0.147 with
    2,048, a quarter frame's in 0.097 and 0.061."""
    return 16 if n >= 2**20 else 8


def _layout_words(n: int, items: int) -> int:
    """The workspace's 32-bit words, as ``csrc/radix_sort.cu:layout``: the
    alternate keys and values, the histogram blocks' counts of the first
    digit, each pass's look-back words, group sums, digit counts and
    ticket."""
    tiles = max(1, -(-n // (BLOCK * items)))
    groups = -(-tiles // GROUP)
    hist_blocks = min(max(1, -(-n // HIST_KEYS)), MAX_HIST_BLOCKS)
    return (2 * n + hist_blocks * DIGITS + PASSES * (tiles + groups) * DIGITS
            + PASSES * DIGITS + PASSES)


def _sort_cuda(keys: torch.Tensor, items: int | None = None):
    """G10 on the card; ``items`` defaults to :func:`design` (the tests
    run both tile sizes at every count)."""
    dev = keys.device
    n = keys.numel()
    _kernels.require(keys, "keys", torch.int32, dev, n)
    if n > MAX_KEYS:
        raise ValueError(f"{n} keys: G10 sorts at most {MAX_KEYS}")
    keys_s = torch.empty(n, dtype=torch.int32, device=dev)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return keys_s, perm
    items = design(n) if items is None else items
    words = _layout_words(n, items)
    ws = torch.empty(words, dtype=torch.int32, device=dev)
    _kernels.launch("oglrt_radix_sort", "radix_sort", dev, keys.data_ptr(),
                    keys_s.data_ptr(), perm.data_ptr(), ws.data_ptr(), words,
                    n, items, kernels=1 + PASSES)
    return keys_s, perm


def sort_rays(keys: torch.Tensor):
    """(keys_s, perm) of the int32 ``keys``: ``torch.sort(keys,
    stable=True)`` with the permutation as int32.  CUDA keys (contiguous)
    launch G10; CPU keys take ``torch.sort``."""
    if keys.is_cuda:
        return _sort_cuda(keys)
    keys_s, perm = torch.sort(keys, stable=True)
    return keys_s, perm.to(torch.int32)
