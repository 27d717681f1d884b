"""Times of the batched small decompositions and solves of the port's SfM
code on one NVIDIA GPU, for several batch sizes B:

  - F-RANSAC (one chunk of 64 pairs x 1,024 hypotheses is B = 65,536):
    torch.linalg.eigh of (B, 9, 9) normal matrices, torch.linalg.svd of
    (B, 3, 3) matrices;
  - the PnP wave (16 images x 768 DLT samples = 12,288 matrices of 12x12,
    16 x 128 EPnP samples with a 12x12 and a 3x3 eigh each, 16 x 1,024 P3P
    poses through a 3x3 svd), triangulation (4x4 eigh per point: up to 256
    pairs x 1,024 points = 262,144), the 5-point solver (10 pairs x 512
    samples = 5,120 solves of 10x10 against 10 right-hand sides, and the
    complete QR of (9, 5) that the port replaces by
    ops/linalg.py null_space_rows), and bundle adjustment (inv_ex of one
    6x6 block per camera).

    python3 scripts/torch_linalg_probe.py

Prints one line per (function, B): milliseconds by CUDA events after a
warm-up, or the error the library raised. Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from recon3d_tpu_torch.ops.linalg import null_space_rows  # noqa: E402


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def spd(gen, B: int, n: int) -> torch.Tensor:
    A = torch.randn((B, 2 * n, n), generator=gen, device="cuda")
    return A.transpose(-1, -2) @ A


def report(name: str, B: int, fn, iters: int = 5) -> None:
    try:
        print(f"{name}, B = {B}: {cuda_ms(fn, iters):.3f} ms", flush=True)
    except RuntimeError as e:
        print(f"{name}, B = {B}: {type(e).__name__}: {str(e)[:160]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_linalg_probe: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        f"; torch {torch.__version__}, CUDA {torch.version.cuda}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B in (1024, 16384, 32768, 65535, 65536, 131072):
        AtA = spd(gen, B, 9)
        M = torch.randn((B, 3, 3), generator=gen, device="cuda")
        report("eigh (B, 9, 9)", B, lambda: torch.linalg.eigh(AtA))
        report("svd (B, 3, 3)", B, lambda: torch.linalg.svd(M))
    # the SfM back end's shapes, up to and beyond what a wave gives them
    for n, sizes in ((12, (2048, 12288, 16384, 32768)), (4, (16384, 32768, 262144)),
                     (3, (2048, 16384, 32768))):
        for B in sizes:
            S = spd(gen, B, n)
            report(f"eigh (B, {n}, {n})", B, lambda: torch.linalg.eigh(S))
    for B in (5120, 16384):
        A = torch.randn((B, 10, 10), generator=gen, device="cuda")
        rhs = torch.randn((B, 10, 10), generator=gen, device="cuda")
        Q = torch.randn((B, 5, 9), generator=gen, device="cuda")
        report("solve_ex (B, 10, 10) x 10 rhs", B, lambda: torch.linalg.solve_ex(A, rhs))
        report("qr complete (B, 9, 5)", B,
               lambda: torch.linalg.qr(Q.transpose(-1, -2), mode="complete"), iters=2)
        report("null_space_rows (B, 5, 9)", B, lambda: null_space_rows(Q))
    for B in (64, 256):
        S = spd(gen, B, 6)
        report("inv_ex (B, 6, 6)", B, lambda: torch.linalg.inv_ex(S))
    A = spd(gen, 4, 6)
    A[1] = 0.0
    A[2, 0, 0] = float("nan")
    x, info = torch.linalg.solve_ex(A, torch.ones((4, 6, 1), device="cuda"))
    print("solve_ex of [regular, singular, NaN, regular]: info", info.tolist(),
          "finite rows", torch.isfinite(x).all(dim=(-2, -1)).tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
