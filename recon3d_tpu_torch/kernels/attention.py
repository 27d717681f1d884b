"""LightGlue's masked multi-head attention as one hand-written CUDA kernel
(csrc/attention.cu), and its plain version.

No Pallas kernel stands behind it: the JAX package's attention
(recon3d_tpu/neural/lightglue.py) is plain jnp. `attention_plain` is that
formula in PyTorch, the matrix products and a softmax over logits masked
with -1e9, in the JAX code's order of operations. csrc/attention.cu says
what bounds the kernel and how it keeps the (B, H, Nq, Nk) logits out of
device memory.

`attention(q, k, v, k_valid)` decides from its inputs which one runs:
tensors on the CPU take the plain version; float32 tensors on the card
launch the kernel, on PyTorch's current stream and the tensors' device,
without a synchronisation. The kernel has no backward pass, so on the card
an input that autograd would record (grad mode on and an input that
requires grad) raises, as does a dtype other than float32 or a head width
other than 32, 64 or 128. A caller that trains calls `attention_plain`
itself: `neural/lightglue.py::Attention` does so in training mode.
`counts` records the launches, and each launch adds 1 to the counter
`neural.attention_kernel` of the trace (runtime/profiling.py). The kernel is compiled on first use with nvcc
into recon3d_tpu_torch/_build (a plain C entry point, loaded with ctypes),
never when this module is imported.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import torch

from recon3d_tpu_torch.kernels.build import build_library
from recon3d_tpu_torch.kernels.warp import NVCC_FLAGS, nvcc
from recon3d_tpu_torch.runtime.profiling import count

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "attention.cu"
HEAD_WIDTHS = (32, 64, 128)


@dataclass
class Counts:
    """Kernel launches since the last reset."""

    kernel: int = 0

    def reset(self) -> None:
        self.kernel = 0


counts = Counts()
_lib = None

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    k_valid: torch.Tensor) -> torch.Tensor:
    """softmax(where(k_valid, q k^T / sqrt(Dh), -1e9)) v: q (B, H, Nq, Dh),
    k and v (B, H, Nk, Dh), k_valid (B, Nk) bool -> (B, Nq, H * Dh)."""
    Dh = q.shape[-1]
    att = torch.matmul(q, k.transpose(-1, -2)) / float(Dh) ** 0.5
    att = torch.where(k_valid[:, None, None, :], att, -1e9)
    out = torch.matmul(torch.softmax(att, dim=-1), v)
    B, H, N, _ = out.shape
    return out.transpose(1, 2).reshape(B, N, H * Dh)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              k_valid: torch.Tensor) -> torch.Tensor:
    """The masked attention of `attention_plain`: on the CPU the plain
    version, on the card the kernel (see the module note)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, k_valid)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "attention: the kernel has no backward, so its result would carry no gradient. "
            "Call it under torch.no_grad() or on inputs that do not require grad, or call "
            "attention_plain to train")
    return launch(q, k, v, k_valid)


def build() -> Tuple[Path, float, str]:
    """Compile csrc/attention.cu into a shared library unless an identical
    build exists. Returns (library path, seconds spent compiling, nvcc's
    log)."""
    return build_library(SOURCE, "attention", nvcc(), NVCC_FLAGS)


def _library():
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        fn = lib.lg_attention_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [_P] * 5 + [_I] * 5 + [_L] * 12 + [ctypes.c_float, _P]
        _lib = lib
    return _lib


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           k_valid: torch.Tensor) -> torch.Tensor:
    """Enqueue the kernel on the current stream: q (B, H, Nq, Dh), k and v
    (B, H, Nk, Dh) float32 on one card, each by its strides, k_valid (B, Nk)
    bool -> a new (B, Nq, H * Dh) tensor. The kernel reads q, k and v in
    rows of 16 bytes: each needs its last axis contiguous and every row on
    a 16-byte boundary, as the projections leave them. Raises on anything
    else."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("attention kernel: q, k and v must be (B, H, N, Dh)")
    B, H, Nq, Dh = q.shape
    Nk = k.shape[2]
    if tuple(k.shape) != (B, H, Nk, Dh) or tuple(v.shape) != (B, H, Nk, Dh):
        raise ValueError(f"attention kernel: k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if tuple(k_valid.shape) != (B, Nk) or k_valid.dtype != torch.bool:
        raise ValueError(f"attention kernel: k_valid must be a ({B}, {Nk}) bool tensor")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise ValueError(f"attention kernel: float32 only, got {q.dtype}, {k.dtype}, {v.dtype}")
    if Dh not in HEAD_WIDTHS:
        raise ValueError(f"attention kernel: head width {Dh} not in {HEAD_WIDTHS}")
    if any(t.device != q.device for t in (k, v, k_valid)):
        raise ValueError("attention kernel: q, k, v and k_valid must be on one device")
    if min(B, H, Nq, Nk) == 0:
        raise ValueError(f"attention kernel: empty input, q {tuple(q.shape)}, k {tuple(k.shape)}")
    if any(t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % 4 for s in t.stride()[:-1])
           for t in (q, k, v)):
        raise ValueError("attention kernel: q, k and v need a contiguous last axis and rows "
                         "on 16-byte boundaries")
    out = torch.empty((B, Nq, H * Dh), dtype=torch.float32, device=q.device)
    k_valid = k_valid.contiguous()
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.lg_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_valid.data_ptr(), out.data_ptr(),
            B, H, Nq, Nk, Dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            k_valid.stride(0), out.stride(0), out.stride(1), 1.0 / float(Dh) ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention kernel failed: CUDA error {rc}")
    counts.kernel += 1
    count("neural.attention_kernel")
    return out
