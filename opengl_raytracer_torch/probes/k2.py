"""K2's row fetch on the card, apart from its math.

The H100 counterpart of the TPU probe ``experiments/shadeglue_ab.py``
(``_sum_kernel_t`` at :89 and ``_sum_kernel_inker`` at :92), which priced
how the JAX shade kernel is fed its material rows.  Two CUDA kernels of
``csrc/probes/k2_rows.cu`` compute the probe's 24-term weighted sum
(``acc = x0; acc = acc + x[a] * (1 + a)``) over R rows gathered by slot:

* :func:`rows_sum` from the (S, 24) row table that K2 reads
  (``SceneData.sh_slot``), six 16-byte loads a row, as K2 fetches it;
* :func:`cols_sum` from a pre-transposed (24, S) table.

On CPU tensors each runs :func:`sum_plain`, the plain torch version in
the same order (the kernels equal it bit for bit on the card).
:func:`probe_inputs` makes the probe's shapes: R = 2,073,600 rays over S =
30,336 rows, sorted slots jittered by +-3, from a seed.  ``chip_smoke.py``
times both beside K2 and prints their bytes bound: what K2's row fetch
alone costs.

The kernels are a library of their own (``PROBE_LIB``) with the launch
count ``_kernels.launch_counts["k2_probe"]``; no path of the renderer
launches them.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from opengl_raytracer_torch.ops import _kernels

R_PROBE = 2_073_600
S_PROBE = 30_336
ROW = 24
PROBE_LIB = os.path.join(_kernels.BUILD_DIR, "liboglrt_k2_probe.so")
SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "probes", "k2_rows.cu")

build_log = ""  # nvcc's output for the probe library (as _kernels')
_lock = threading.Lock()
_lib = None


def probe_inputs(seed: int, R: int = R_PROBE, S: int = S_PROBE,
                 device="cpu"):
    """(table (S, 24) f32, table_t (24, S) f32, slots (R,) i32): a normal
    table and sorted slots jittered by +-3, clipped to the table, as
    shadeglue_ab.py makes them."""
    g = np.random.default_rng(seed)
    table = g.standard_normal((S, ROW)).astype(np.float32)
    base = np.sort(g.integers(0, S, size=R))
    slots = np.clip(base + g.integers(-3, 4, size=R), 0, S - 1)
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(np.ascontiguousarray(table.T)).to(device),
            torch.from_numpy(slots.astype(np.int32)).to(device))


def sum_plain(columns) -> torch.Tensor:
    """The weighted sum over the 24 gathered (R,) columns, in the
    kernels' order."""
    acc = columns[0].clone()
    for a in range(1, ROW):
        acc = acc + columns[a] * float(1 + a)
    return acc


def build() -> str:
    """Compile ``SOURCE`` into ``PROBE_LIB`` unless it is newer; returns
    its path.  Raises when nvcc fails."""
    global build_log
    if (os.path.exists(PROBE_LIB)
            and os.path.getmtime(PROBE_LIB) >= os.path.getmtime(SOURCE)):
        build_log = _kernels.saved_log(PROBE_LIB)
        return PROBE_LIB
    build_log = _kernels.compile_library(PROBE_LIB, [(SOURCE, [])])
    return PROBE_LIB


def lib() -> ctypes.CDLL:
    """The probe library, built and loaded at first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build())
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            so.oglrt_k2_rows_sum.restype = i32
            so.oglrt_k2_rows_sum.argtypes = [p, p, p, i64, p]
            so.oglrt_k2_cols_sum.restype = i32
            so.oglrt_k2_cols_sum.argtypes = [p, i64, p, p, i64, p]
            _lib = so
        return _lib


def _check(table, slots, shape):
    dev = slots.device
    _kernels.require(slots, "slots", torch.int32, dev)
    _kernels.require(table, "table", torch.float32, dev)
    if table.dim() != 2 or tuple(table.shape) != shape:
        raise ValueError(f"table must be {shape}, got {tuple(table.shape)}")


def rows_sum(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """The sum over rows ``table[slots]`` of an (S, 24) table; every slot
    must lie in [0, S) (the kernel does not check)."""
    _check(table, slots, (table.shape[0], ROW))
    if not slots.is_cuda:
        return sum_plain(table[slots.long()].unbind(1))
    if table.data_ptr() % 16:
        raise ValueError("the row table must be 16-byte aligned")
    out = torch.empty(slots.numel(), dtype=torch.float32, device=slots.device)
    _kernels.launch("oglrt_k2_rows_sum", "k2_probe", slots.device,
                    table.data_ptr(), slots.data_ptr(), out.data_ptr(),
                    slots.numel(), library=lib())
    return out


def cols_sum(table_t: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """The same sum from a pre-transposed (24, S) table."""
    _check(table_t, slots, (ROW, table_t.shape[1]))
    if not slots.is_cuda:
        return sum_plain(table_t[:, slots.long()].unbind(0))
    out = torch.empty(slots.numel(), dtype=torch.float32, device=slots.device)
    _kernels.launch("oglrt_k2_cols_sum", "k2_probe", slots.device,
                    table_t.data_ptr(), table_t.shape[1], slots.data_ptr(),
                    out.data_ptr(), slots.numel(), library=lib())
    return out


def bytes_moved(R: int, S: int) -> int:
    """What either sum must move: the table once, each slot read and each
    sum written once."""
    return S * ROW * 4 + R * 4 + R * 4
