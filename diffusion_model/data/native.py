"""ctypes bindings for the native (C++) dataset-builder kernels.

Loads ``native/libgraphbuild.so`` (building it with make/g++ on first use
when it is missing or older than ``native/graphbuild.cpp``, so the library
always comes from the committed source) and exposes the shell-BFS / distance / kNN routines. Every entry
point has a numpy fallback in data/shells.py and ops/edges.py — the native
path is a drop-in accelerator, verified equal in tests.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgraphbuild.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "graphbuild.cpp")
_lib = None
_load_failed = False


def _build_library() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True, capture_output=True, timeout=120,
        )
        return os.path.isfile(_LIB_PATH)
    except Exception:
        return False


def _is_stale() -> bool:
    return (not os.path.isfile(_LIB_PATH)
            or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH))


def load_library():
    """The shared library, or None if unavailable (numpy fallback applies)."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if _is_stale() and not _build_library():
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        _load_failed = True
        return None
    lib.build_shells.restype = ctypes.c_int
    lib.build_shells.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    lib.distance_matrix.restype = None
    lib.distance_matrix.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.knn_indices.restype = None
    lib.knn_indices.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return load_library() is not None


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_shells_native(lattice: np.ndarray, frac: np.ndarray,
                        exo_index: int, n_shells: int, cutoff: float = 2.0):
    """Native twin of shells.shell_indices over the 3x3x3 supercell.

    Returns (pos [M,3] float64 relative to exO, src [M] int32 unit-cell site
    indices, exO first).
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    lattice = np.ascontiguousarray(lattice, np.float64)
    frac = np.ascontiguousarray(frac, np.float64)
    n = frac.shape[0]
    max_out = 27 * n
    out_pos = np.zeros((max_out, 3), np.float64)
    out_src = np.zeros((max_out,), np.int32)
    count = lib.build_shells(
        _dptr(lattice), _dptr(frac), n, exo_index, n_shells,
        ctypes.c_double(cutoff), _dptr(out_pos), _iptr(out_src), max_out,
    )
    if count < 0:
        raise RuntimeError("build_shells overflow or bad exo_index")
    return out_pos[:count], out_src[:count]


def distance_matrix_native(pos: np.ndarray) -> np.ndarray:
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    pos = np.ascontiguousarray(pos, np.float64)
    n = pos.shape[0]
    out = np.zeros((n, n), np.float64)
    lib.distance_matrix(_dptr(pos), n, _dptr(out))
    return out


def knn_indices_native(pos: np.ndarray, k: int) -> np.ndarray:
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    pos = np.ascontiguousarray(pos, np.float64)
    n = pos.shape[0]
    out = np.zeros((n, k), np.int32)
    lib.knn_indices(_dptr(pos), n, k, _iptr(out))
    return out
