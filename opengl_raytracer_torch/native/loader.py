"""Loader for the native (C++) BVH builder.

The builder's source is ``opengl_raytracer_tpu/native/bvh.cpp`` in the same
repository.  It is compiled from that path, never imported: the JAX
package's Python modules import JAX, which this package does not use.  The
library goes into ``build/native/`` at the repository root with the same
g++ flags the JAX package uses, so both packages build identical trees.
When no compiler is available, ``ops/bvh.py`` falls back to its NumPy
builder.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCE = os.path.join(_REPO, "opengl_raytracer_tpu", "native", "bvh.cpp")
_BUILD_DIR = os.path.join(_REPO, "build", "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "liboglrt_bvh.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    if not os.path.exists(_SOURCE):
        return False
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SOURCE)):
        return True
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           _SOURCE, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError):
        return False
    os.replace(tmp, _LIB_PATH)  # atomic: concurrent builders never see half
    return True


def get_lib():
    """The loaded native library, building it if needed; None if
    unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.bvh_build.restype = ctypes.c_longlong
        lib.bvh_build.argtypes = [
            f32p, f32p, f32p,                  # v0, v1, v2
            ctypes.c_longlong,                 # T
            ctypes.c_int,                      # max_leaf_tris
            ctypes.c_int,                      # method: 0 mean, 1 binned SAH
            f32p, f32p,                        # node_min, node_max (2T x 3)
            i32p, i32p, i32p,                  # node_miss, first, count
            ctypes.POINTER(ctypes.c_longlong),  # perm (T)
            i32p,                              # depth (1)
            ctypes.c_int,                      # progress
        ]
        _lib = lib
        return _lib


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                     max_leaf_tris: int, method: int = 0):
    """C++ BVH build -> ``ops.bvh.BVH``; None if the library is
    unavailable.  method: 0 = reference mean-split, 1 = binned SAH."""
    lib = get_lib()
    if lib is None:
        return None
    T = v0.shape[0]
    cap = 2 * T  # binary BVH with non-empty leaves has < 2T nodes
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_miss = np.empty(cap, np.int32)
    node_first = np.empty(cap, np.int32)
    node_count = np.empty(cap, np.int32)
    perm = np.empty(T, np.int64)
    depth = np.zeros(1, np.int32)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

    c0 = np.ascontiguousarray(v0, np.float32)
    c1 = np.ascontiguousarray(v1, np.float32)
    c2 = np.ascontiguousarray(v2, np.float32)
    n = lib.bvh_build(
        fp(c0), fp(c1), fp(c2), T, max_leaf_tris, method,
        fp(node_min), fp(node_max), ip(node_miss), ip(node_first),
        ip(node_count),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        ip(depth), 0,
    )
    if n <= 0:
        raise RuntimeError(f"native BVH build failed ({n})")
    from opengl_raytracer_torch.ops.bvh import BVH

    return BVH(
        node_min=node_min[:n].copy(),
        node_max=node_max[:n].copy(),
        node_miss=node_miss[:n].copy(),
        node_first=node_first[:n].copy(),
        node_count=node_count[:n].copy(),
        perm=perm,
        depth=int(depth[0]),
    )
