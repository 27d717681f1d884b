"""Windowed normalized cross-correlation (the dense backends' inner op).

PyTorch port of recon3d_tpu/ops/ncc.py::ncc_windowed (:30-50): five
box-filtered moment maps, plain PyTorch. The vmap over source planes
becomes broadcasting over leading dimensions.
"""

from __future__ import annotations

import torch

from recon3d_tpu_torch.ops.image import box_filter


def ncc_windowed(ref: torch.Tensor, src: torch.Tensor, ok: torch.Tensor,
                 patch: int = 11) -> torch.Tensor:
    """Masked windowed NCC of ref against each source plane.

    src (..., H, W) and its validity ok (same shape); ref (..., H, W)
    broadcastable to src (JAX: ref (H, W), src (J, H, W)). Returns NCC of
    src's shape in [-1, 1], -1.0 where the source sample is invalid. Window
    means are sum(x*w)/sum(w) over the patch window."""
    w = ok.to(src.dtype)
    cnt = box_filter(w, patch) + 1e-6
    mr = box_filter(ref * w, patch) / cnt
    ms = box_filter(src * w, patch) / cnt
    cov = box_filter(ref * src * w, patch) / cnt - mr * ms
    vr = torch.clamp_min(box_filter(ref * ref * w, patch) / cnt - mr * mr, 1e-8)
    vs = torch.clamp_min(box_filter(src * src * w, patch) / cnt - ms * ms, 1e-8)
    ncc = torch.clamp(cov / torch.sqrt(vr * vs), -1.0, 1.0)
    return torch.where(ok, ncc, -1.0)


# The JAX package's name for its XLA entry point, kept for callers that
# import it by module path.
ncc_windowed_xla = ncc_windowed
