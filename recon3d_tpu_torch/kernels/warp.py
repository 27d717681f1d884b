"""K1, the bilinear warp, as a hand-written CUDA kernel (csrc/warp.cu).

Replaces recon3d_tpu/ops/warp_pallas.py::_tent_warp_kernel, the JAX
package's only Pallas kernel. It computes the exact gather formula of
recon3d_tpu/ops/image.py::bilinear_sample for a batch of 2-D planes: see
the note at the top of csrc/warp.cu for what bounds it and why it is a
4-tap gather rather than the TPU's tent-weight matrix product.

`tent_warp` is the wrapper: a CPU tensor goes to `tent_warp_reference`,
the plain PyTorch version; a CUDA tensor launches the kernel or raises.
`counts` records how often each of the two ran.

The kernel is compiled on first use with nvcc into recon3d_tpu_torch/_build
(a plain C entry point, loaded with ctypes), keyed by a hash of the source
and flags, so nothing is ever built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "warp.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class LaunchCounts:
    """How often `tent_warp` launched the kernel and took the plain version;
    by_shape splits the launches by `shape_key`."""

    kernel: int = 0
    plain: int = 0
    by_shape: Counter = field(default_factory=Counter)

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0
        self.by_shape.clear()


def shape_key(planes: torch.Tensor, coords: torch.Tensor) -> str:
    """'NxHxW/NcxM': planes (N, H, W) sampled at coords (Nc, M, 2)."""
    N, H, W = planes.shape
    return f"{N}x{H}x{W}/{coords.shape[0]}x{coords.shape[1]}"


counts = LaunchCounts()
_lib = None


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); K1 cannot be built")


def build() -> Tuple[Path, float, str]:
    """Compile csrc/warp.cu into a shared library unless an identical build
    exists. Returns (library path, seconds spent compiling, nvcc's log)."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libwarp_{digest}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return lib_path, 0.0, log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return lib_path, seconds, log


def _library():
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.tent_warp_f32.restype = ctypes.c_int
        lib.tent_warp_f32.argtypes = [
            ctypes.c_void_p,     # planes
            ctypes.c_void_p,     # coords
            ctypes.c_void_p,     # out
            ctypes.c_void_p,     # valid
            ctypes.c_longlong,   # n_planes
            ctypes.c_longlong,   # samples per plane
            ctypes.c_longlong,   # coordinate stride between planes
            ctypes.c_int,        # H
            ctypes.c_int,        # W
            ctypes.c_float,      # fill
            ctypes.c_void_p,     # stream
        ]
        _lib = lib
    return _lib


def _check(planes: torch.Tensor, coords: torch.Tensor) -> None:
    if planes.dtype != torch.float32 or coords.dtype != torch.float32:
        raise TypeError(
            f"tent_warp takes float32 planes and coords, got {planes.dtype}, "
            f"{coords.dtype}"
        )
    if planes.dim() != 3:
        raise ValueError(f"planes must be (N, H, W), got {tuple(planes.shape)}")
    if coords.dim() != 3 or coords.shape[-1] != 2:
        raise ValueError(f"coords must be (N or 1, M, 2), got {tuple(coords.shape)}")
    if coords.shape[0] not in (1, planes.shape[0]):
        raise ValueError(
            f"coords lead dim {coords.shape[0]} must be 1 or N={planes.shape[0]}"
        )
    if planes.device != coords.device:
        raise ValueError(f"planes on {planes.device}, coords on {coords.device}")


def tent_warp_reference(
    planes: torch.Tensor, coords: torch.Tensor, fill: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: recon3d_tpu/ops/image.py:98-144 for a
    batch of planes. planes (N, H, W); coords (N or 1, M, 2) as (x, y).
    Returns (samples (N, M) float32, valid (N, M) bool)."""
    N, H, W = planes.shape
    x = coords[..., 0]
    y = coords[..., 1]
    valid = (
        (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
        & torch.isfinite(x) & torch.isfinite(y)
    )
    # Invalid coordinates are zeroed before the integer cast (a NaN or inf
    # cast is undefined); their samples are replaced by `fill` below.
    x = torch.where(valid, x, 0.0)
    y = torch.where(valid, y, 0.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)

    flat = planes.reshape(N, H * W)
    M = coords.shape[1]

    def tap(yi, xi):
        return torch.gather(flat, 1, (yi * W + xi).expand(N, M))

    out = (
        tap(y0i, x0i) * (1 - fx) * (1 - fy)
        + tap(y0i, x1i) * fx * (1 - fy)
        + tap(y1i, x0i) * (1 - fx) * fy
        + tap(y1i, x1i) * fx * fy
    )
    valid = valid.expand(N, M)
    return torch.where(valid, out, fill), valid


def tent_warp(
    planes: torch.Tensor, coords: torch.Tensor, fill: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear samples of N planes: the K1 kernel on CUDA tensors, the plain
    version on CPU tensors. Same arguments and results as
    `tent_warp_reference`. Inputs must be contiguous float32."""
    _check(planes, coords)
    if planes.device.type == "cpu":
        counts.plain += 1
        return tent_warp_reference(planes, coords, fill)
    if planes.device.type != "cuda":
        raise ValueError(f"tent_warp: unsupported device {planes.device}")
    if not (planes.is_contiguous() and coords.is_contiguous()):
        raise ValueError("tent_warp: planes and coords must be contiguous")
    if coords.data_ptr() % 8:
        raise ValueError("tent_warp: coords must be 8-byte aligned (float2 loads)")
    N, H, W = planes.shape
    M = coords.shape[1]
    out = torch.empty((N, M), dtype=torch.float32, device=planes.device)
    # one validity row for shared coordinates, expanded as the plain version does
    valid = torch.empty((coords.shape[0], M), dtype=torch.bool, device=planes.device)
    if N * M == 0:
        return out, valid.expand(N, M)
    lib = _library()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        rc = lib.tent_warp_f32(
            planes.data_ptr(), coords.data_ptr(), out.data_ptr(),
            valid.data_ptr(), N, M, 0 if coords.shape[0] == 1 else M,
            H, W, float(fill), stream,
        )
    if rc != 0:
        raise RuntimeError(f"tent_warp kernel launch failed: CUDA error {rc}")
    counts.kernel += 1
    counts.by_shape[shape_key(planes, coords)] += 1
    return out, valid.expand(N, M)
