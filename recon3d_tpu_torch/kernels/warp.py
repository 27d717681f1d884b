"""K1, the bilinear warp, as a hand-written CUDA kernel (csrc/warp.cu).

Replaces recon3d_tpu/ops/warp_pallas.py::_tent_warp_kernel, the JAX
package's only Pallas kernel. It computes the exact gather formula of
recon3d_tpu/ops/image.py::bilinear_sample for a batch of 2-D planes: see
the note at the top of csrc/warp.cu for what bounds it and why it is a
4-tap gather rather than the TPU's tent-weight matrix product.

`tent_warp` is the wrapper: a CPU tensor goes to `tent_warp_reference`,
the plain PyTorch version; a CUDA tensor launches the kernel or raises.
K1 is forward only, as the JAX kernel (no custom_vjp): on the card the
wrapper refuses inputs that require grad while grad mode is on, where the
plain version on the CPU would differentiate.
`counts` records how often each of the two ran. `plan_launch`, a pure
function of the shapes and the coordinate pointer's alignment, picks the
kernel's variant (own or shared points, taps from L1/L2 or from shared
memory), its grid, block, vector width and dynamic shared memory.

The kernel is compiled on first use with nvcc into recon3d_tpu_torch/_build
(a plain C entry point, loaded with ctypes), keyed by a hash of the source
and flags, so nothing is ever built when this module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

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
    by_shape splits the launches by `shape_key`, by_variant by the variant
    `plan_launch` chose."""

    kernel: int = 0
    plain: int = 0
    by_shape: Counter = field(default_factory=Counter)
    by_variant: Counter = field(default_factory=Counter)

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0
        self.by_shape.clear()
        self.by_variant.clear()


def shape_key(planes: torch.Tensor, coords: torch.Tensor) -> str:
    """'NxHxW/NcxM': planes (N, H, W) sampled at coords (Nc, M, 2)."""
    N, H, W = planes.shape
    return f"{N}x{H}x{W}/{coords.shape[0]}x{coords.shape[1]}"


# ---- the launch planner ---------------------------------------------------

# The kernel's variants, numbered as csrc/warp.cu::tent_warp_launch takes
# them: own points (coordinate row n for plane n) with taps through L1/L2,
# and points shared by all planes with taps through L1/L2 or from planes
# staged in shared memory.
VARIANTS = ("plane", "shared", "shared_smem")
THREADS = {"plane": 256, "shared": 256, "shared_smem": 1024}
MAX_GRID_Y = 65_535
MAX_THREADS_PER_SM = 2048
SMEM_RESERVED_PER_BLOCK = 1024
# The planner narrows the points a thread takes until a launch has this
# many threads an SM: below it, small launches are bound by latency, which
# more threads hide better than wider loads do (PERF.md, K1's variants).
MIN_THREADS_PER_SM = 1024


@dataclass(frozen=True)
class DeviceLimits:
    sms: int
    smem_block: int  # dynamic shared memory one block may opt into, bytes
    smem_sm: int     # shared memory of one SM, bytes


H100 = DeviceLimits(sms=132, smem_block=232_448, smem_sm=233_472)


@dataclass(frozen=True)
class LaunchPlan:
    variant: str
    grid: Tuple[int, int]
    block: int
    vec: int
    smem_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def staged_bytes(n_floats: int) -> int:
    """Dynamic shared memory of `shared_smem`: the planes, then the 8-byte
    mbarrier at the next 16-byte boundary."""
    return _cdiv(4 * n_floats, 16) * 16 + 8


def variants_for(N: int, H: int, W: int, Nc: int,
                 limits: DeviceLimits = H100) -> List[str]:
    """The variants that can take planes (N, H, W) at coords (Nc, M, 2):
    `shared_smem` only where all N planes fit one block's shared memory."""
    if Nc != 1:
        return ["plane"]
    fits = staged_bytes(N * H * W) <= limits.smem_block
    return ["shared", "shared_smem"] if fits else ["shared"]


def vec_widths(M: int, coords_align: int) -> List[int]:
    """Points a thread may take at once, widest first: 4 and 2 load their
    coordinates as float4 (16-byte aligned, M a multiple of the width),
    1 as float2."""
    return [v for v in (4, 2) if M % v == 0 and coords_align % 16 == 0] + [1]


@functools.lru_cache(maxsize=256)
def plan_launch(N: int, H: int, W: int, Nc: int, M: int, coords_align: int,
                limits: DeviceLimits = H100, variant: Optional[str] = None,
                vec: Optional[int] = None) -> LaunchPlan:
    """K1's launch for planes (N, H, W) sampled at coords (Nc, M, 2) whose
    data pointer is `coords_align` bytes past a 16-byte boundary.

    Own points take `plane`: a 2-D grid with the plane on y (at most
    65,535; the kernel loops beyond). Shared points take `shared_smem`
    where all planes fit one block's shared memory: a persistent grid of as
    many blocks as fit on the SMs at once, each staging the planes once;
    else `shared`. vec: the widest of `vec_widths` that leaves the launch
    MIN_THREADS_PER_SM threads an SM, else 1. `variant` and `vec` force one
    of `variants_for`'s and `vec_widths`'."""
    if N < 1 or M < 1 or H < 1 or W < 1 or Nc not in (1, N):
        raise ValueError(f"K1 plan: planes ({N}, {H}, {W}), coords ({Nc}, {M}, 2)")
    if M >= 2**30 or H * W >= 2**30:
        raise ValueError(f"K1 indexes a plane and a coordinate row with 32 bits "
                         f"(below 2^30): H*W={H * W}, M={M}")
    if coords_align % 8:
        raise ValueError("tent_warp: coords must be 8-byte aligned (float2 loads)")
    widths = vec_widths(M, coords_align)
    if vec is None:
        points = M if Nc == 1 else N * M
        vec = next((v for v in widths if points // v >= limits.sms * MIN_THREADS_PER_SM), 1)
    elif vec not in widths:
        raise ValueError(f"K1 takes {widths} points a thread at M={M}, coordinates "
                         f"{coords_align} bytes past 16, not {vec}")
    options = variants_for(N, H, W, Nc, limits)
    if variant is None:
        variant = options[-1]
    elif variant not in options:
        raise ValueError(f"K1 variant {variant!r} cannot take planes ({N}, {H}, {W}) at "
                         f"coords ({Nc}, {M}, 2); it can take {options}")
    threads = THREADS[variant]
    groups = M // vec
    if variant == "plane":
        return LaunchPlan(variant, (_cdiv(groups, threads), min(N, MAX_GRID_Y)), threads, vec, 0)
    if variant == "shared":
        return LaunchPlan(variant, (_cdiv(groups, threads), 1), threads, vec, 0)
    smem = staged_bytes(N * H * W)
    per_sm = max(1, min(MAX_THREADS_PER_SM // threads,
                        limits.smem_sm // (smem + SMEM_RESERVED_PER_BLOCK)))
    blocks = min(limits.sms * per_sm, _cdiv(groups, threads))
    return LaunchPlan(variant, (blocks, 1), threads, vec, smem)


counts = LaunchCounts()
_lib = None


@contextlib.contextmanager
def record_launches(by_stage: dict, name: str):
    """Record `counts`' change inside the block under by_stage[name]: the
    kernel's launches (in all, by shape and by variant) and the plain
    version's calls (the CLIs' --stats-json)."""
    k0, p0 = counts.kernel, counts.plain
    s0, v0 = counts.by_shape.copy(), counts.by_variant.copy()
    yield
    by_stage[name] = {"kernel": counts.kernel - k0, "plain": counts.plain - p0,
                      "kernel_by_shape": dict(counts.by_shape - s0),
                      "kernel_by_variant": dict(counts.by_variant - v0)}


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
        lib.tent_warp_launch.restype = ctypes.c_int
        lib.tent_warp_launch.argtypes = [
            ctypes.c_int,        # variant (index into VARIANTS)
            ctypes.c_int,        # points per thread and step (vec)
            ctypes.c_void_p,     # planes
            ctypes.c_void_p,     # coords
            ctypes.c_void_p,     # out
            ctypes.c_void_p,     # valid
            ctypes.c_longlong,   # n_planes
            ctypes.c_longlong,   # points per coordinate row
            ctypes.c_int,        # H
            ctypes.c_int,        # W
            ctypes.c_float,      # fill
            ctypes.c_uint,       # grid x
            ctypes.c_uint,       # grid y
            ctypes.c_int,        # threads per block
            ctypes.c_int,        # dynamic shared memory, bytes
            ctypes.c_void_p,     # stream
        ]
        lib.tent_warp_device_info.restype = ctypes.c_int
        lib.tent_warp_device_info.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
        _lib = lib
    return _lib


_limits: Dict[int, DeviceLimits] = {}


def device_limits(device: torch.device) -> DeviceLimits:
    """SMs and shared memory of a CUDA device, read with
    cudaDeviceGetAttribute once per device."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _limits:
        vals = [ctypes.c_int(0) for _ in range(3)]
        rc = _library().tent_warp_device_info(index, *(ctypes.addressof(v) for v in vals))
        if rc != 0:
            raise RuntimeError(f"cudaDeviceGetAttribute failed: CUDA error {rc}")
        _limits[index] = DeviceLimits(*(v.value for v in vals))
    return _limits[index]


def plan_for(planes: torch.Tensor, coords: torch.Tensor, variant: Optional[str] = None,
             vec: Optional[int] = None) -> LaunchPlan:
    """plan_launch for these CUDA tensors on their device."""
    N, H, W = planes.shape
    return plan_launch(N, H, W, coords.shape[0], coords.shape[1], coords.data_ptr() % 16,
                       device_limits(planes.device), variant, vec)


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
    planes: torch.Tensor, coords: torch.Tensor, fill: float = 0.0,
    variant: Optional[str] = None, vec: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear samples of N planes: the K1 kernel on CUDA tensors, the plain
    version on CPU tensors. Same arguments and results as
    `tent_warp_reference`. Inputs must be contiguous float32, coords 8-byte
    aligned. `variant` and `vec` force the kernel's variant and points a
    thread in place of the planner's choice (`plan_launch`)."""
    _check(planes, coords)
    if planes.device.type == "cpu":
        if variant is not None or vec is not None:
            raise ValueError("tent_warp: variant and vec name a CUDA kernel's launch; the "
                             "CPU runs the plain version")
        counts.plain += 1
        return tent_warp_reference(planes, coords, fill)
    if planes.device.type != "cuda":
        raise ValueError(f"tent_warp: unsupported device {planes.device}")
    if torch.is_grad_enabled() and (planes.requires_grad or coords.requires_grad):
        raise RuntimeError(
            "tent_warp: K1 has no backward (the JAX kernel defines none either); the "
            "kernel's result would carry no gradient. Call it under torch.no_grad() or "
            "on inputs that do not require grad")
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
    plan = plan_for(planes, coords, variant, vec)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        rc = lib.tent_warp_launch(
            VARIANTS.index(plan.variant), plan.vec, planes.data_ptr(), coords.data_ptr(),
            out.data_ptr(), valid.data_ptr(), N, M, H, W, float(fill),
            plan.grid[0], plan.grid[1], plan.block, plan.smem_bytes, stream,
        )
    if rc != 0:
        raise RuntimeError(f"tent_warp kernel launch failed ({plan}): CUDA error {rc}")
    counts.kernel += 1
    counts.by_shape[shape_key(planes, coords)] += 1
    counts.by_variant[plan.variant] += 1
    return out, valid.expand(N, M)
