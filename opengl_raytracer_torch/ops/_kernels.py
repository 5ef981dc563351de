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
per kernel (G3's reorder: its two kernels; G10's sort: its 1 + passes);
``launch`` adds one where it launches a kernel and nowhere else, so a
caller can show which kernels a run went through.  A CUDA graph's replay
passes no wrapper: the graph keeps the counts its capture made and adds
them at each replay (``step_graph.py``).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

import torch

from opengl_raytracer_torch.utils import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "liboglrt_torch_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# K1, K2 and K3 ("subblock_traversal" counts K1's launches, each of a
# whole part chain; "subblock_parts" the parts that they walked, P a
# launch); the glue kernels of the main path:
# "ray_front" (G1), "sort_keys" (G2), "radix_sort" (G10, the sort: its
# histogram launch and its passes), "reorder" and "restore" (G3),
# "wide_epilogue" (G5, K3's prologue and epilogue), "band_fold" (G6) and
# "step_block" (the step block's write), "bvh_walk" (G7, the "bvh"
# traversal), "brute_sweep" (G8, the "brute" traversal), "packet_walk"
# (G9, the "packet" traversal), "to_uint8" (the App's display conversion,
# ops/display.py); and the probes' kernels
# (opengl_raytracer_torch/probes/), which no path of the renderer launches:
# "k1_profile" and "k3_profile" count the profile builds of K1 and K3,
# "k3_fetch" K3's octet fetch, "k2_probe" K2's row-fetch sums
launch_counts = {"subblock_traversal": 0, "subblock_parts": 0, "shade": 0,
                 "wide_traversal": 0, "ray_front": 0, "sort_keys": 0,
                 "radix_sort": 0, "reorder": 0, "restore": 0,
                 "wide_epilogue": 0, "band_fold": 0, "step_block": 0,
                 "bvh_walk": 0,
                 "brute_sweep": 0, "packet_walk": 0, "to_uint8": 0,
                 "k1_profile": 0, "k3_profile": 0, "k3_fetch": 0,
                 "k2_probe": 0}
PROBE_COUNTERS = ("k1_profile", "k3_profile", "k3_fetch", "k2_probe")

_lock = threading.Lock()
_lib = None
# nvcc's output for the loaded library: of this process's build, or read
# back from the log kept beside a library built earlier (saved_log)
build_log = ""


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


def compile_library(lib_path: str, units: list) -> str:
    """Compile ``units``, a list of (source, extra nvcc flags), one ``nvcc
    -c`` each, all started together, and link them into ``lib_path``;
    returns nvcc's output, each unit's under a line ``== <file> <flags>``,
    and keeps it beside the library (:func:`saved_log`).  Raises when nvcc
    fails.  Span ``kernels.build``."""
    with profiling.Span("kernels.build",
                        {"library": os.path.basename(lib_path)}):
        return _compile_library(lib_path, units)


def _compile_library(lib_path: str, units: list) -> str:
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.{threading.get_ident()}.tmp"
    objs = [f"{lib_path}.{i}.{tag}.o" for i in range(len(units))]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *flags, "-c", "-o", o, s],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for (s, flags), o in zip(units, objs)]
    outs = [p.communicate()[0] for p in procs]  # waits for every process
    log = "".join(f"== {os.path.basename(s)} {' '.join(flags)}\n{out}"
                  for (s, flags), out in zip(units, outs))
    try:
        failed = [(s, p.returncode) for (s, _), p in zip(units, procs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = f"{lib_path}.{tag}"
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{log}")
        with open(f"{tmp}.log", "w") as f:
            f.write(log)
        os.replace(f"{tmp}.log", f"{lib_path}.log")
        os.replace(tmp, lib_path)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return log


def saved_log(lib_path: str) -> str:
    """nvcc's output of the build that made ``lib_path``, "" if none was
    kept."""
    try:
        with open(f"{lib_path}.log") as f:
            return f.read()
    except FileNotFoundError:
        return ""


def build() -> str:
    """Compile ``csrc/*.cu`` into ``LIB_PATH`` unless it is newer than
    every source and header; returns the library's path.  Raises when
    nvcc fails."""
    global build_log
    srcs = sources()
    deps = srcs + glob.glob(os.path.join(_CSRC, "*.cuh"))
    if (os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH)
            >= max(os.path.getmtime(s) for s in deps)):
        build_log = saved_log(LIB_PATH)
        return LIB_PATH
    build_log = compile_library(LIB_PATH, [(s, []) for s in srcs])
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The kernel library, built and loaded at first use (span
    ``kernels.load``)."""
    global _lib
    with _lock:
        if _lib is None:
            with profiling.Span("kernels.load"):
                _lib = _load()
        return _lib


def _load() -> ctypes.CDLL:
    so = ctypes.CDLL(build())
    p, i32, i64, f32, u32 = (ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_float,
                             ctypes.c_uint32)
    # (7 ray columns, the parts' host table, n_parts, 5 outputs, overflow, n)
    so.oglrt_subblock_traverse_parts.restype = i32
    so.oglrt_subblock_traverse_parts.argtypes = ([p] * 8 + [i32] + [p] * 6
                                                 + [i64, p])
    so.oglrt_shade.restype = i32
    # (table, n_rows, 18 inputs, the step block, 14 outputs, n)
    so.oglrt_shade.argtypes = [p, i32] + [p] * 33 + [i64, p]
    # (..., nodes, octets, groups, ...)
    so.oglrt_wide_traverse.restype = i32
    so.oglrt_wide_traverse.argtypes = [p] * 9 + [i32] + [p] * 5 + [i64, p]
    # the glue kernels: (block, base, n_rays, n_band, tw, blocks,
    # 6 floats, out, seed_out, n); (6 columns, alive, lo, inv_ext,
    # keys, n); (perm, sorted keys, columns, seed, orig, scratch, 4
    # outputs, return_seed, block or null, base, n_rays, n_band, tw,
    # the LCG advance (a, c), n); (orig, 3 columns, seed or null, 2
    # outputs, n); (active or null, t0, n); (K3's 4 columns, remap, n_remap, 4 outputs, n);
    # (block, 3 colour columns, n_band, tw, th, n_frames, weight,
    # width, blocks); (block, host words)
    so.oglrt_ray_front.restype = i32
    so.oglrt_ray_front.argtypes = ([p, i64, i64, i64, i32, i32]
                                   + [f32] * 6 + [p, p, i64, p])
    so.oglrt_sort_keys.restype = i32
    so.oglrt_sort_keys.argtypes = [p] * 10 + [i64, p]
    so.oglrt_reorder.restype = i32
    so.oglrt_reorder.argtypes = ([p] * 10 + [i32, p, i64, i64, i64,
                                             i32, u32, u32, i64, p])
    so.oglrt_restore.restype = i32
    so.oglrt_restore.argtypes = [p] * 7 + [i64, p]
    # G10: (keys, sorted keys, permutation, workspace, its words, n, keys
    # a pass thread)
    so.oglrt_radix_sort.restype = i32
    so.oglrt_radix_sort.argtypes = [p] * 4 + [i64, i64, i32, p]
    so.oglrt_wide_prologue.restype = i32
    so.oglrt_wide_prologue.argtypes = [p, p, i64, p]
    so.oglrt_wide_epilogue.restype = i32
    so.oglrt_wide_epilogue.argtypes = ([p] * 5 + [i32] + [p] * 4
                                       + [i64, p])
    so.oglrt_band_fold.restype = i32
    so.oglrt_band_fold.argtypes = ([p] * 4 + [i64, i32, i32, i32, f32,
                                              i32, i32, p])
    so.oglrt_write_block.restype = i32
    so.oglrt_write_block.argtypes = [p, p, p]
    # G7 and G9: (6 ray columns, active or null, node records,
    # wide, n_nodes, triangle records, max_leaf, 4 outputs, n);
    # G8: (6 ray columns, active or null, triangle records, n_tris,
    # 4 outputs, n)
    for walk in (so.oglrt_bvh_walk, so.oglrt_packet_walk):
        walk.restype = i32
        walk.argtypes = ([p] * 8 + [i32, i32, p, i32] + [p] * 4
                         + [i64, p])
    so.oglrt_brute_sweep.restype = i32
    so.oglrt_brute_sweep.argtypes = ([p] * 8 + [i32] + [p] * 4
                                     + [i64, p])
    # (frame, bytes, n)
    so.oglrt_to_uint8.restype = i32
    so.oglrt_to_uint8.argtypes = [p, p, i64, p]
    return so


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError`` from a launch."""
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(symbol: str, counter: str, device: torch.device, *args,
           library: ctypes.CDLL | None = None, kernels: int = 1) -> None:
    """Launch ``symbol`` of ``library`` (default: :func:`lib`) on
    ``device``: call it with ``args`` and the device's current stream while
    ``device`` is the current one, add ``kernels`` (the kernels ``symbol``
    launches) to ``launch_counts[counter]``, and raise on a launch error.

    A ctypes launch runs in the context of the CURRENT device, whatever
    device its pointers and stream belong to, so the guard is what keeps a
    kernel for ``cuda:1`` off ``cuda:0`` when a process drives several
    cards (``parallel/sharding.py``)."""
    with torch.cuda.device(device):
        err = getattr(library or lib(), symbol)(*args, stream_ptr(device))
    launch_counts[counter] += kernels
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
