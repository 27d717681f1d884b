"""Times of the batched small decompositions of the port's F-RANSAC on one
NVIDIA GPU: torch.linalg.eigh of (B, 9, 9) normal matrices and
torch.linalg.svd of (B, 3, 3) matrices, for several batch sizes B (one
chunk of 64 pairs x 1,024 hypotheses is B = 65,536).

    python3 scripts/torch_linalg_probe.py

Prints one line per (function, B): milliseconds by CUDA events after a
warm-up, or the error the library raised. Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys

import torch


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
        A = torch.randn((B, 17, 9), generator=gen, device="cuda")
        AtA = A.transpose(-1, -2) @ A
        M = torch.randn((B, 3, 3), generator=gen, device="cuda")
        for name, fn in (("eigh (B, 9, 9)", lambda: torch.linalg.eigh(AtA)),
                         ("svd (B, 3, 3)", lambda: torch.linalg.svd(M))):
            try:
                print(f"{name}, B = {B}: {cuda_ms(fn, 5):.3f} ms", flush=True)
            except RuntimeError as e:
                print(f"{name}, B = {B}: {type(e).__name__}: {str(e)[:160]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
