"""ctypes loader for the native C++ host runtime (librecon3d_native.so).

PyTorch port: a verbatim copy of recon3d_tpu/runtime/native.py. It loads the
same shared library from the repository's native/ directory.

The reference delegates host-side point-cloud work to compiled libraries
(scipy cKDTree dense.py:261, sklearn dense_stereo.py:446, OpenCV C++
everywhere). This framework's equivalents live in native/ (C++17, built
with `make -C native`): grid-hash voxel downsampling, k-NN mean distances,
and binary PLY encode/decode. Every entry point has a pure-numpy fallback
in the callers, so the framework works without the .so.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for cand in (
        os.path.join(here, "..", "native", "librecon3d_native.so"),
        os.path.join(here, "native", "librecon3d_native.so"),
    ):
        cand = os.path.abspath(cand)
        if os.path.exists(cand):
            try:
                lib = ctypes.CDLL(cand)
            except OSError:
                continue
            lib.voxel_downsample.restype = ctypes.c_longlong
            lib.voxel_downsample.argtypes = [
                ctypes.POINTER(ctypes.c_float),  # points
                ctypes.c_longlong,               # n
                ctypes.c_float,                  # voxel size
                ctypes.POINTER(ctypes.c_longlong),  # out indices
            ]
            lib.knn_mean_dist.restype = ctypes.c_int
            lib.knn_mean_dist.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_longlong,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
            ]
            try:
                lib.nearest_index.restype = ctypes.c_int
                lib.nearest_index.argtypes = [
                    ctypes.POINTER(ctypes.c_float),     # ref
                    ctypes.c_longlong,                  # n
                    ctypes.POINTER(ctypes.c_float),     # query
                    ctypes.c_longlong,                  # m
                    ctypes.POINTER(ctypes.c_longlong),  # out indices
                ]
            except AttributeError:
                pass  # older .so without nearest_index
            try:
                lib.ply_write_ascii_rows.restype = ctypes.c_int
                lib.ply_write_ascii_rows.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_ubyte),
                    ctypes.c_longlong,
                ]
                lib.ply_parse_ascii_rows.restype = ctypes.c_longlong
                lib.ply_parse_ascii_rows.argtypes = [
                    ctypes.c_char_p,
                    ctypes.c_longlong,
                    ctypes.c_longlong,
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_double),
                ]
            except AttributeError:
                pass  # older .so without the PLY entry points
            _LIB = lib
            break
    return _LIB


def native_available() -> bool:
    return _load() is not None


def native_voxel_downsample(points: np.ndarray, voxel: float) -> Optional[np.ndarray]:
    """Returns sorted kept indices, or None if the library is unavailable."""
    lib = _load()
    if lib is None or len(points) == 0:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty(len(pts), np.int64)
    n = lib.voxel_downsample(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_longlong(len(pts)),
        ctypes.c_float(voxel),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
    )
    if n < 0:
        return None
    return np.sort(out[:n])


def native_knn_mean_dist(points: np.ndarray, k: int) -> Optional[np.ndarray]:
    """Mean distance to the k nearest neighbors per point, or None."""
    lib = _load()
    if lib is None or len(points) == 0:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty(len(pts), np.float32)
    rc = lib.knn_mean_dist(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_longlong(len(pts)),
        ctypes.c_int(k),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        return None
    return out


def native_nearest_index(
    query: np.ndarray, ref: np.ndarray
) -> Optional[np.ndarray]:
    """Index of the nearest `ref` point for every `query` point (exact,
    grid-hash shells), or None if the library lacks the entry point."""
    lib = _load()
    if lib is None or len(ref) == 0 or len(query) == 0:
        return None
    if not hasattr(lib, "nearest_index"):
        return None
    r = np.ascontiguousarray(ref, np.float32)
    q = np.ascontiguousarray(query, np.float32)
    out = np.empty(len(q), np.int64)
    rc = lib.nearest_index(
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_longlong(len(r)),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_longlong(len(q)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
    )
    if rc != 0:
        return None
    return out


def native_ply_write_ascii(
    path: str, points: np.ndarray, colors: np.ndarray
) -> bool:
    """Append ASCII vertex rows to `path` (header already written)."""
    lib = _load()
    if lib is None or not hasattr(lib, "ply_write_ascii_rows"):
        return False
    pts = np.ascontiguousarray(points, np.float32)
    cols = np.ascontiguousarray(colors, np.uint8)
    rc = lib.ply_write_ascii_rows(
        path.encode(),
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.c_longlong(len(pts)),
    )
    return rc == 0


def native_ply_parse_ascii(
    path: str, offset: int, n: int, n_props: int
) -> Optional[np.ndarray]:
    """Parse n ASCII vertex rows of n_props numbers -> (n, n_props) float64."""
    lib = _load()
    if lib is None or not hasattr(lib, "ply_parse_ascii_rows"):
        return None
    out = np.empty((n, n_props), np.float64)
    got = lib.ply_parse_ascii_rows(
        path.encode(),
        ctypes.c_longlong(offset),
        ctypes.c_longlong(n),
        ctypes.c_int(n_props),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if got != n:
        return None
    return out
