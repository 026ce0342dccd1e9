"""ctypes bindings for the native data-plane (native/plyio.cpp).

A copy of ``hyperpocket_tpu/data/native.py``: the library is
``native/libhpcd.so`` under the repo root (built with ``make -C native``),
else one on the loader's path. ``plyio.load_ply`` tries it first and reads
with numpy where it does not load or cannot parse a file (ASCII PLY), as
the JAX package does; ``available()`` reports whether it loads.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache

import numpy as np

_LIB_NAME = "libhpcd.so"


@lru_cache(maxsize=1)
def _load_lib():
    candidates = [
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                     "native", _LIB_NAME),
        _LIB_NAME,
    ]
    for path in candidates:
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        lib.hpcd_load_ply.restype = ctypes.c_int64
        lib.hpcd_load_ply.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_int64]
        lib.hpcd_ply_vertex_count.restype = ctypes.c_int64
        lib.hpcd_ply_vertex_count.argtypes = [ctypes.c_char_p]
        lib.hpcd_load_ply_batch.restype = ctypes.c_int64
        lib.hpcd_load_ply_batch.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                            ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.hpcd_save_ply.restype = ctypes.c_int64
        lib.hpcd_save_ply.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_int64]
        return lib
    return None


def available() -> bool:
    return _load_lib() is not None


def load_ply(path: str) -> np.ndarray:
    """Native binary-LE PLY read -> (N, 3) float32."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native library not built; run `make -C native`")
    encoded = os.fspath(path).encode()
    count = lib.hpcd_ply_vertex_count(encoded)
    if count < 0:
        raise IOError(f"cannot read PLY header of {path} (rc={count})")
    out = np.empty((count, 3), dtype=np.float32)
    rc = lib.hpcd_load_ply(encoded, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), count)
    if rc < 0:
        raise IOError(f"native PLY read failed for {path} (rc={rc})")
    return out[:rc]


def load_ply_batch(paths: list[str], points_per_cloud: int, n_threads: int = 0) -> np.ndarray:
    """Parallel native load of many fixed-size clouds -> (len(paths), P, 3)."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native library not built; run `make -C native`")
    blob = b"".join(os.fspath(p).encode() + b"\0" for p in paths)
    out = np.empty((len(paths), points_per_cloud, 3), dtype=np.float32)
    rc = lib.hpcd_load_ply_batch(
        blob, len(paths), points_per_cloud,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads,
    )
    if rc != 0:
        # rc > 0 is the 1-based index of the failing file; anything else is
        # an unexpected error code, so don't fabricate a filename from it
        if 0 < rc <= len(paths):
            raise IOError(
                f"native batch load failed at {paths[rc - 1]} (wrong size or unreadable)"
            )
        raise IOError(f"native batch load failed (rc={rc})")
    return out


def save_ply(path: str, points: np.ndarray) -> None:
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native library not built; run `make -C native`")
    pts = np.ascontiguousarray(points, dtype=np.float32)
    rc = lib.hpcd_save_ply(os.fspath(path).encode(),
                           pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pts.shape[0])
    if rc != 0:
        raise IOError(f"native PLY write failed for {path} (rc={rc})")
