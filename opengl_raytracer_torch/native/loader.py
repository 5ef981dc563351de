"""Loader for the native (C++) OBJ parser and BVH builder.

Their sources are ``objparser.cpp`` and ``bvh.cpp`` beside this module:
byte-for-byte copies of ``opengl_raytracer_tpu/native/``'s, so that this
package builds without the JAX package and both parse and build
identically.  They compile with the JAX package's g++ flags into
``build/native/`` at the repository root (built into a temporary file and
renamed, so a process never loads a half-written library).  When no
compiler is available, ``models/obj.py`` and ``ops/bvh.py`` fall back to
their Python versions.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from opengl_raytracer_torch.utils import profiling

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCES = [os.path.join(os.path.dirname(os.path.abspath(__file__)), s)
            for s in ("objparser.cpp", "bvh.cpp")]
_BUILD_DIR = os.path.join(_REPO, "build", "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "liboglrt_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    """Compile ``_SOURCES`` into ``_LIB_PATH`` unless the library is newer
    than every source (span ``native.build``); False when a source is
    missing or g++ fails."""
    if not all(os.path.exists(s) for s in _SOURCES):
        return False
    if (os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH)
            >= max(os.path.getmtime(s) for s in _SOURCES)):
        return True
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           *_SOURCES, "-o", tmp]
    try:
        with profiling.Span("native.build"):
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
        lib.obj_parse.restype = ctypes.c_longlong
        lib.obj_parse.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.c_int]  # progress
        lib.obj_free.restype = None
        lib.obj_free.argtypes = [ctypes.c_void_p]

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


def load_obj_native(file_path: str, progress: bool = False) -> np.ndarray:
    """Parse an OBJ with the C++ parser -> (N, 8) float32, the layout of
    ``models/obj.py:load_obj_py``.  ``progress`` prints the reference's
    carriage-return percent bar from the C++ side (loadObject.pyx:20-21).
    Raises RuntimeError without the library and IOError when the parse
    fails (a missing file, an index out of range)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out_ptr = ctypes.c_void_p()
    n_floats = lib.obj_parse(file_path.encode(), ctypes.byref(out_ptr),
                             int(bool(progress)))
    if n_floats < 0:
        raise IOError(f"native OBJ parse failed for {file_path!r} ({n_floats})")
    try:
        buf = ctypes.cast(out_ptr, ctypes.POINTER(ctypes.c_float))
        arr = np.ctypeslib.as_array(buf, shape=(n_floats,)).copy()
    finally:
        lib.obj_free(out_ptr)
    return arr.reshape(-1, 8)


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                     max_leaf_tris: int, method: int = 0,
                     progress: bool = False):
    """C++ BVH build -> ``ops.bvh.BVH``; None if the library is
    unavailable.  method: 0 = reference mean-split, 1 = binned SAH.
    ``progress`` prints the reference's percent bar from the C++ side."""
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
        ip(depth), int(bool(progress)),
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
