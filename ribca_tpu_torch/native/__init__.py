"""Native (C++) host runtime helpers, loaded through ctypes.

Build-on-first-use: ``ensure_built()`` compiles ``mask_scan.cpp`` with the
system g++ into the package's git-ignored ``_build/`` directory and caches
the handle. Every caller has a fallback (ops/extents.py, outputs/colorize.py),
so the port works identically without a compiler; native only changes speed.

Why native here: the reference's hot host loops are pure Python (mask
scanning, per-cell painting). The port keeps heavy math on the GPU and
gives the residual host-side work, mask statistics and full-slide map
painting, a C++ fast path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "mask_scan.cpp")


def _lib_path() -> str:
    out_dir = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "_build")
    return os.path.join(out_dir, "libribca_native.so")


def ensure_built() -> ctypes.CDLL | None:
    """Compile (if needed) and load the native library; None on failure."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _lib_path()
        try:
            if not os.path.exists(path) or (
                os.path.getmtime(path) < os.path.getmtime(_SRC)
            ):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                # private name, then rename: concurrent processes never
                # load a half-written library
                tmp = f"{path}.{os.getpid()}.tmp"
                # no -march=native: a build directory copied to another
                # machine must not hold instructions its CPU lacks
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                    check=True, capture_output=True,
                )
                os.replace(tmp, path)
            lib = ctypes.CDLL(path)
            lib.mask_scan.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.mask_scan.restype = None
            lib.lut_paint_rgb.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.lut_paint_rgb.restype = None
            lib.ribca_native_abi_version.restype = ctypes.c_int32
            if lib.ribca_native_abi_version() != 1:
                raise OSError("native library ABI mismatch")
            _LIB = lib
        except (OSError, subprocess.CalledProcessError):
            _LIB = None
        return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def mask_scan(mask: np.ndarray, n_ids: int | None = None):
    """Single-pass per-cell statistics of an int32 instance mask.

    Returns (rmin, rmax, cmin, cmax, count, rsum, csum) numpy arrays of
    length n_ids; raises RuntimeError when the native lib is unavailable
    (ops/extents.py then falls back to its torch path)."""
    lib = ensure_built()
    if lib is None:
        raise RuntimeError("native library unavailable")
    mask = np.ascontiguousarray(mask, dtype=np.int32)
    if n_ids is None:
        n_ids = int(mask.max()) + 1
    h, w = mask.shape
    rmin = np.empty(n_ids, np.int32)
    rmax = np.empty(n_ids, np.int32)
    cmin = np.empty(n_ids, np.int32)
    cmax = np.empty(n_ids, np.int32)
    count = np.empty(n_ids, np.int64)
    rsum = np.empty(n_ids, np.int64)
    csum = np.empty(n_ids, np.int64)
    lib.mask_scan(
        _ptr(mask, ctypes.c_int32), h, w, n_ids,
        _ptr(rmin, ctypes.c_int32), _ptr(rmax, ctypes.c_int32),
        _ptr(cmin, ctypes.c_int32), _ptr(cmax, ctypes.c_int32),
        _ptr(count, ctypes.c_int64), _ptr(rsum, ctypes.c_int64),
        _ptr(csum, ctypes.c_int64),
    )
    return rmin, rmax, cmin, cmax, count, rsum, csum


def lut_paint_rgb(mask: np.ndarray, table: np.ndarray) -> np.ndarray:
    """out[p] = table[mask[p]] for an (n_ids, 3) uint8 table."""
    lib = ensure_built()
    if lib is None:
        raise RuntimeError("native library unavailable")
    mask = np.ascontiguousarray(mask, dtype=np.int32)
    table = np.ascontiguousarray(table, dtype=np.uint8)
    out = np.empty((*mask.shape, 3), np.uint8)
    lib.lut_paint_rgb(
        _ptr(mask, ctypes.c_int32), mask.size,
        _ptr(table, ctypes.c_uint8), table.shape[0],
        _ptr(out, ctypes.c_uint8),
    )
    return out
