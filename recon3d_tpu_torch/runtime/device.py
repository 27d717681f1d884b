"""Device selection for the port's entry points.

The port's counterpart of JAX_PLATFORMS: an entry point runs on "cuda"
unless its caller asks for "cpu". Asking for CUDA where there is no GPU is
an error, never a quiet move to the CPU. TF32 is switched off because the
JAX reference pins float32 contractions to Precision.HIGHEST
(recon3d_tpu/dense/patchmatch.py:64, tests/conftest.py:27).
"""

from __future__ import annotations

import torch


def disable_tf32() -> None:
    """Full float32 matrix products and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(name) -> torch.device:
    """torch.device for "cuda" / "cpu" (or a torch.device), with TF32 off.

    Raises RuntimeError for a CUDA device when no GPU is visible."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(name)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(name)!r}")
    disable_tf32()
    return dev
