"""SuperPoint keypoint detector and descriptor.

PyTorch port of recon3d_tpu/neural/superpoint.py: the published
architecture (DeTone et al., 2018), a VGG-style shared encoder, a
65-channel detector head (8x8 cells and a dustbin) and a 256-d descriptor
head. Layer names are those of the JAX package's checkpoints
(conv1a ... convDb), so neural.weights.load_params_npz fills them from the
bundled .npz. The network runs NCHW inside and takes and returns the JAX
package's NHWC layout at its boundary.

Static capacity: max_keypoints slots with a validity mask instead of a
dynamic keypoint count. The descriptors are sampled at the keypoints with
ops/image.bilinear_sample_auto: K1 (kernels/warp.py) on a CUDA tensor, the
D descriptor planes sharing the keypoints in one launch; its plain version
on the CPU, which is the JAX package's bilinear_sample.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from recon3d_tpu_torch.ops.image import bilinear_sample_auto
from recon3d_tpu_torch.ops.select import topk_nonneg_first

_CONVS = (  # name, in, out, kernel
    ("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3),
    ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
    ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
    ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
    ("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
    ("convDa", 128, 256, 3),
)


class SuperPointNet(nn.Module):
    """Backbone and heads. Input (B, H, W, 1) float32 in [0, 1] with H, W
    multiples of 8; returns logits (B, H/8, W/8, 65) and unit descriptors
    (B, H/8, W/8, D)."""

    def __init__(self, descriptor_dim: int = 256):
        super().__init__()
        self.descriptor_dim = descriptor_dim
        for name, cin, cout, k in _CONVS:
            self.add_module(name, nn.Conv2d(cin, cout, k, padding=k // 2))
        self.convDb = nn.Conv2d(256, descriptor_dim, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        for block in ("1", "2", "3"):
            x = F.relu(getattr(self, f"conv{block}a")(x))
            x = F.relu(getattr(self, f"conv{block}b")(x))
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.conv4a(x))
        x = F.relu(self.conv4b(x))
        logits = self.convPb(F.relu(self.convPa(x)))
        desc = self.convDb(F.relu(self.convDa(x)))
        # rsqrt(sum^2 + eps), as the JAX network normalises
        desc = desc * torch.rsqrt((desc * desc).sum(dim=1, keepdim=True) + 1e-8)
        return logits.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)


def scores_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """(B, Hc, Wc, 65) -> dense (B, H, W) keypoint probability map: softmax
    over the 65 channels, the dustbin dropped, depth-to-space 8x8."""
    prob = torch.softmax(logits, dim=-1)[..., :64]
    B, Hc, Wc, _ = prob.shape
    prob = prob.reshape(B, Hc, Wc, 8, 8)
    return prob.permute(0, 1, 3, 2, 4).reshape(B, Hc * 8, Wc * 8)


def simple_nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep the scores that equal the maximum of their (2r+1)^2 window
    (max_pool2d pads with -inf: the JAX reduce_window's "SAME" padding)."""
    mx = F.max_pool2d(scores[:, None], 2 * radius + 1, stride=1, padding=radius)[:, 0]
    return torch.where(scores >= mx, scores, 0.0)


@dataclass
class NeuralFeatures:
    """Padded keypoints of one image.

    xy: (K, 2) pixels; score: (K,); desc: (K, D) L2-normalized; valid: (K,)."""

    xy: torch.Tensor
    score: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor


def detect_keypoints(
    scores: torch.Tensor,
    desc_coarse: torch.Tensor,
    max_keypoints: int,
    detection_threshold: float = 0.0005,
    nms_radius: int = 4,
    border: int = 4,
) -> NeuralFeatures:
    """(H, W) score map and (H/8, W/8, D) coarse descriptors -> padded
    features: NMS, masked top-k at a static capacity, subpixel refinement,
    bilinear descriptor sampling. The top-k puts equal scores in
    lax.top_k's order (ascending index), so the slots are the JAX ones."""
    H, W = scores.shape
    dev = scores.device
    s = simple_nms(scores[None], nms_radius)[0]
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    inb = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    s = torch.where(inb, s, 0.0)

    vals, idx = topk_nonneg_first(s.reshape(-1), max_keypoints)
    valid = vals > detection_threshold
    yi = idx // W
    xi = idx % W

    # Subpixel refinement: a 1-D quadratic fit per axis on the raw score
    # map (NMS zeroes the neighbours), offset -d / (2 d2) clamped to +-0.5,
    # 0 where the curvature is flat.
    def _refine(sm1, s0, sp1):
        d = 0.5 * (sp1 - sm1)
        d2 = sp1 - 2.0 * s0 + sm1
        off = torch.where(d2 < -1e-12, -d / torch.clamp(d2, max=-1e-12), 0.0)
        return torch.clamp(off, -0.5, 0.5)

    s0 = scores[yi, xi]
    x = xi.to(torch.float32) + _refine(scores[yi, (xi - 1).clamp_min(0)], s0,
                                       scores[yi, (xi + 1).clamp_max(W - 1)])
    y = yi.to(torch.float32) + _refine(scores[(yi - 1).clamp_min(0), xi], s0,
                                       scores[(yi + 1).clamp_max(H - 1), xi])
    xy = torch.stack([x, y], dim=-1)

    # Descriptors sampled at the keypoints, in cell units.
    cell_xy = torch.stack([(x + 0.5) / 8.0 - 0.5, (y + 0.5) / 8.0 - 0.5], dim=-1)
    desc, _ = bilinear_sample_auto(desc_coarse, cell_xy)
    desc = desc / torch.linalg.norm(desc, dim=-1, keepdim=True).clamp_min(1e-12)
    return NeuralFeatures(xy=xy, score=vals, desc=desc, valid=valid)


def neural_to_sift_features(feats: NeuralFeatures):
    """Wrap neural keypoints in the classical SiftFeatures container, with
    the defaults of an OpenCV KeyPoint for scale and angle (size 10, angle
    -1), so that code written against the SIFT front end takes them."""
    from recon3d_tpu_torch.ops.sift import SiftFeatures

    k = feats.xy.shape[0]
    dev = feats.xy.device
    return SiftFeatures(
        xy=feats.xy,
        scale=torch.full((k,), 10.0, dtype=torch.float32, device=dev),
        angle=torch.full((k,), -1.0, dtype=torch.float32, device=dev),
        response=feats.score,
        desc=feats.desc,
        valid=feats.valid,
    )
