"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface under
``build/torch_kernels/`` at the repository root, at first use, and loaded
with ``ctypes``.  There is no fallback: a wrapper given CUDA tensors either
launches its kernel or raises.  The build is not fast-math (``/`` and
``sqrt`` stay IEEE-rounded; mul+add contraction is allowed).

Every wrapper launches through :func:`launch`, which makes its tensors'
device the current one for the call.  ``launch_counts`` holds one integer
per kernel; ``launch`` adds one where it launches a kernel and nowhere
else, so a caller can show which kernels a run went through.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "liboglrt_torch_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launch_counts = {"subblock_traversal": 0, "shade": 0, "wide_traversal": 0}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the last build in this process


def reset_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "cannot be built")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def build() -> str:
    """Compile ``csrc/*.cu`` into ``LIB_PATH`` unless it is newer than
    every source; returns the library's path.  Raises when nvcc fails."""
    global build_log
    srcs = sources()
    if (os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH)
            >= max(os.path.getmtime(s) for s in srcs)):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
            for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    outs = [p.communicate()[0] for p in procs]  # waits for every process
    build_log = "".join(outs)
    try:
        failed = [(s, p.returncode) for s, p in zip(srcs, procs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp = f"{LIB_PATH}.{tag}"
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, LIB_PATH)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The kernel library, built and loaded at first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build())
            p, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_longlong, ctypes.c_float)
            so.oglrt_subblock_traverse.restype = i32
            so.oglrt_subblock_traverse.argtypes = [p] * 14 + [i64, p]
            so.oglrt_shade.restype = i32
            so.oglrt_shade.argtypes = ([p, i32] + [p] * 18
                                       + [f32, f32, f32, f32, i32]
                                       + [p] * 14 + [i64, p])
            so.oglrt_wide_traverse.restype = i32
            so.oglrt_wide_traverse.argtypes = ([p] * 9 + [i64, i32, i32]
                                               + [p] * 5 + [i64, p])
            _lib = so
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError`` from a launch."""
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(symbol: str, counter: str, device: torch.device, *args) -> None:
    """Launch the library's ``symbol`` on ``device``: call it with ``args``
    and the device's current stream while ``device`` is the current one,
    add one to ``launch_counts[counter]``, and raise on a launch error.

    A ctypes launch runs in the context of the CURRENT device, whatever
    device its pointers and stream belong to, so the guard is what keeps a
    kernel for ``cuda:1`` off ``cuda:0`` when a process drives several
    cards (``parallel/sharding.py``)."""
    with torch.cuda.device(device):
        err = getattr(lib(), symbol)(*args, stream_ptr(device))
    launch_counts[counter] += 1
    check(err, symbol)


def require(t: torch.Tensor, name: str, dtype, device, numel=None) -> None:
    """The checks a kernel's wrapper makes on each tensor it passes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected {numel}")
