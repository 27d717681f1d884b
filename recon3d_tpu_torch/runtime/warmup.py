"""Background device warm-up (PyTorch port of recon3d_tpu/runtime/warmup.py).

The first CUDA call of a process creates the CUDA context, and K1's first
launch loads (and on a fresh checkout builds with nvcc) its library. Left
alone, both land inside whatever stage touches the card first.

warm_device_async(device) moves them off the critical path: a daemon
thread creates the context, loads K1's library through kernels/warp.py and
makes one host->device and one device->host copy, while the caller does
its host-side work. On the CPU it makes one tiny tensor op.

PyTorch creates cuBLAS and cuSOLVER handles per thread, so this thread
does not warm another thread's handles: a caller that needs them warm runs
a small matmul and solve on its own thread (the serve daemon's `warm`).
"""

from __future__ import annotations

import threading

_started = threading.Event()
_done = threading.Event()


def _warm(device: str) -> None:
    try:
        import torch

        dev = torch.device(device)
        if dev.type == "cuda":
            from recon3d_tpu_torch.kernels import warp

            torch.cuda.init()
            warp._library()
        # one h2d + one d2h: float() waits for the result
        float(torch.ones(1).to(dev) + 1.0)
    except Exception:
        # Warm-up is best-effort; real device errors surface at first use.
        pass
    finally:
        _done.set()


def warm_device_async(device: str = "cuda") -> threading.Event:
    """Start the warm-up thread (idempotent). Returns the completion event
    (the serve daemon waits on it before it answers requests)."""
    if not _started.is_set():
        _started.set()
        threading.Thread(
            target=_warm, args=(str(device),), name="recon3d-device-warmup", daemon=True
        ).start()
    return _done
