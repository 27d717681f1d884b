"""The port's native point-cloud runtime, at the JAX package's names
(recon3d_tpu/runtime/native.py).

The JAX package loads a host C++ library built elsewhere
(native/librecon3d_native.so). The port never opens it. Its counterparts:
- the searches run on the device: `native_knn_mean_dist` through K2 and
  `native_nearest_index` through K3 (kernels/pointcloud.py, CUDA kernels
  on a GPU, their plain versions on the CPU), `native_voxel_downsample`
  as torch ops on the device;
- the ASCII PLY routines are the port's own copy in csrc/pointcloud_host.cpp,
  compiled at first use with the host's `g++ -O3 -std=c++17 -fPIC -shared`
  into recon3d_tpu_torch/_build and loaded from there.

Each function takes numpy and gives numpy, as the JAX one does, with an
added `device=` (the card unless the caller asks for the CPU) where it
computes. Where the JAX function returns None for a missing library, this
one raises: a failed build or launch is an error.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.kernels import pointcloud
from recon3d_tpu_torch.kernels.build import build_library, find_tool
from recon3d_tpu_torch.runtime.device import resolve_device

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "pointcloud_host.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_LIB = None


def build() -> Tuple[Path, float, str]:
    """Compile csrc/pointcloud_host.cpp with g++ unless an identical build
    exists. Returns (library path, seconds spent compiling, g++'s log)."""
    return build_library(SOURCE, "pointcloud_host", find_tool("g++"), CXX_FLAGS)


def _load():
    global _LIB
    if _LIB is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
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
        _LIB = lib
    return _LIB


def native_available() -> bool:
    """Whether the port's host library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _points(points: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(resolve_device(device))


def native_voxel_downsample(points: np.ndarray, voxel: float,
                            device="cuda") -> Optional[np.ndarray]:
    """Sorted indices of the first point of every occupied voxel."""
    return pointcloud.voxel_first_indices(_points(points, device), voxel).cpu().numpy()


def native_knn_mean_dist(points: np.ndarray, k: int, device="cuda") -> Optional[np.ndarray]:
    """Mean distance to the k nearest neighbours per point, under the JAX
    native search's ring rule (K2)."""
    return pointcloud.knn_mean_dist(_points(points, device), k).cpu().numpy()


def native_nearest_index(query: np.ndarray, ref: np.ndarray,
                         device="cuda") -> Optional[np.ndarray]:
    """Index of the nearest `ref` point for every `query` point (exact; the
    lowest index among equal squared distances; K3)."""
    return pointcloud.nearest_index(_points(ref, device), _points(query, device)).cpu().numpy()


def native_ply_write_ascii(path: str, points: np.ndarray, colors: np.ndarray) -> bool:
    """Append ASCII vertex rows to `path` (header already written). Returns
    True; raises OSError when the file cannot be written."""
    pts = np.ascontiguousarray(points, np.float32)
    cols = np.ascontiguousarray(colors, np.uint8)
    rc = _load().ply_write_ascii_rows(
        path.encode(),
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.c_longlong(len(pts)),
    )
    if rc != 0:
        raise OSError(f"writing the PLY rows of {path} failed")
    return True


def native_ply_parse_ascii(path: str, offset: int, n: int,
                           n_props: int) -> Optional[np.ndarray]:
    """Parse n ASCII vertex rows of n_props numbers -> (n, n_props) float64,
    or None when the file holds fewer well-formed rows (as the JAX one)."""
    out = np.empty((n, n_props), np.float64)
    got = _load().ply_parse_ascii_rows(
        path.encode(),
        ctypes.c_longlong(offset),
        ctypes.c_longlong(n),
        ctypes.c_int(n_props),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if got != n:
        return None
    return out
