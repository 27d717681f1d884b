"""LightGlue feature matcher.

PyTorch port of recon3d_tpu/neural/lightglue.py: the published
architecture (Lindenberger et al., 2023), L transformer layers of
self-attention (with a 2-D rotary encoding of the normalized keypoint
positions) and bidirectional cross-attention, then a matchability head
and a sigmoid-log-double-softmax assignment. As in the JAX package, the
adaptive depth and point pruning of the original are left out: all L
layers run over padded keypoint sets with masks, and matches are the
mutual argmax of the padded score matrix.

Every function takes a leading batch of pairs: (B, N, ...) where the JAX
functions take (N, ...) under vmap. Attention is written as the JAX code
writes it, matrix products and a masked softmax with -1e9, and not as
scaled_dot_product_attention, whose fused backends sum in another order.
Layer names are those of the JAX package's checkpoints (input_proj,
layer0 ... layer8, final_proj, matchability, rotary_freqs).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from recon3d_tpu_torch.ops.select import argmax_first


def normalize_keypoints(xy: torch.Tensor, hw) -> torch.Tensor:
    """Centre and scale keypoints to about [-1, 1]; hw = (h, w)."""
    h, w = float(hw[0]), float(hw[1])
    size = torch.tensor([w, h], dtype=xy.dtype, device=xy.device)
    return (xy - size / 2.0) / (max(w, h) / 2.0)


def rotary_embed(xy: torch.Tensor, freqs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D rotary position encoding: xy (..., N, 2), freqs (2, F) -> cos,
    sin (..., N, 2F)."""
    ang = xy @ freqs
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate feature pairs: x (..., heads, N, D) with D even; cos, sin
    (..., N, D)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    rot = torch.cat([-x2, x1], dim=-1)
    c = cos[..., None, :, : d // 2]
    s = sin[..., None, :, : d // 2]
    return x * torch.cat([c, c], dim=-1) + rot * torch.cat([s, s], dim=-1)


class Attention(nn.Module):
    """Multi-head attention over padded sets with key-validity masking."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.to_q = nn.Linear(dim, dim)
        self.to_k = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.Linear(dim, dim)

    def _heads(self, x):
        B, N, _ = x.shape
        return x.reshape(B, N, self.num_heads, -1).transpose(1, 2)   # (B, H, N, Dh)

    def forward(self, q_in, k_in, v_in, k_valid, q_rot=None, k_rot=None):
        Dh = self.dim // self.num_heads
        q = self._heads(self.to_q(q_in))
        k = self._heads(self.to_k(k_in))
        v = self._heads(self.to_v(v_in))
        if q_rot is not None:
            q = apply_rotary(q, *q_rot)
            k = apply_rotary(k, *k_rot)
        att = torch.matmul(q, k.transpose(-1, -2)) / float(Dh) ** 0.5
        att = torch.where(k_valid[:, None, None, :], att, -1e9)
        out = torch.matmul(torch.softmax(att, dim=-1), v)
        B, _, N, _ = out.shape
        return self.to_out(out.transpose(1, 2).reshape(B, N, self.dim))


class MessageUpdate(nn.Module):
    """x <- x + MLP([x | message]), with exact GELU and LayerNorm eps 1e-5."""

    def __init__(self, dim: int):
        super().__init__()
        self.ffn1 = nn.Linear(2 * dim, 2 * dim)
        self.ln = nn.LayerNorm(2 * dim, eps=1e-5)
        self.ffn2 = nn.Linear(2 * dim, dim)

    def forward(self, x, message):
        y = self.ffn1(torch.cat([x, message], dim=-1))
        y = F.gelu(self.ln(y), approximate="none")
        return x + self.ffn2(y)


class LightGlueLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        for name in ("self_attn0", "self_attn1", "cross_attn0", "cross_attn1"):
            self.add_module(name, Attention(dim, num_heads))
        for name in ("self_upd0", "self_upd1", "cross_upd0", "cross_upd1"):
            self.add_module(name, MessageUpdate(dim))

    def forward(self, x0, x1, v0, v1, rot0, rot1):
        # self-attention with the rotary position encoding
        m0 = self.self_attn0(x0, x0, x0, v0, q_rot=rot0, k_rot=rot0)
        m1 = self.self_attn1(x1, x1, x1, v1, q_rot=rot1, k_rot=rot1)
        x0 = self.self_upd0(x0, m0)
        x1 = self.self_upd1(x1, m1)
        # bidirectional cross-attention, no position encoding
        c0 = self.cross_attn0(x0, x1, x1, v1)
        c1 = self.cross_attn1(x1, x0, x0, v0)
        return self.cross_upd0(x0, c0), self.cross_upd1(x1, c1)


class LightGlueNet(nn.Module):
    """Descriptors and positions of two padded sets -> assignment.

    forward(desc0 (B, N0, D), desc1 (B, N1, D), xy0n, xy1n (normalized
    positions), valid0 (B, N0), valid1 (B, N1) bool) -> (log_assign
    (B, N0, N1), matchability0 (B, N0), matchability1 (B, N1))."""

    def __init__(self, dim: int = 256, num_heads: int = 4, num_layers: int = 9):
        super().__init__()
        self.dim, self.num_heads, self.num_layers = dim, num_heads, num_layers
        # input_proj, final_proj and matchability are shared by both sets
        self.input_proj = nn.Linear(dim, dim)
        self.rotary_freqs = nn.Parameter(torch.zeros(2, dim // num_heads // 2))
        for i in range(num_layers):
            self.add_module(f"layer{i}", LightGlueLayer(dim, num_heads))
        self.final_proj = nn.Linear(dim, dim)
        self.matchability = nn.Linear(dim, 1)

    def forward(self, desc0, desc1, xy0n, xy1n, valid0, valid1):
        x0 = self.input_proj(desc0)
        x1 = self.input_proj(desc1)
        rot0 = rotary_embed(xy0n, self.rotary_freqs)
        rot1 = rotary_embed(xy1n, self.rotary_freqs)
        for i in range(self.num_layers):
            x0, x1 = getattr(self, f"layer{i}")(x0, x1, valid0, valid1, rot0, rot1)

        f0 = self.final_proj(x0) / self.dim ** 0.25
        f1 = self.final_proj(x1) / self.dim ** 0.25
        sim = torch.matmul(f0, f1.transpose(-1, -2))
        m0 = self.matchability(x0)[..., 0]
        m1 = self.matchability(x1)[..., 0]

        # sigmoid-log-double-softmax (LightGlue eq. 8)
        z = (sim + torch.where(valid0, 0.0, -1e9)[..., :, None]
             + torch.where(valid1, 0.0, -1e9)[..., None, :])
        log_assign = (torch.log_softmax(z, dim=-1) + torch.log_softmax(z, dim=-2)
                      + F.logsigmoid(m0)[..., :, None] + F.logsigmoid(m1)[..., None, :])
        return log_assign, torch.sigmoid(m0), torch.sigmoid(m1)


class LightGlueMatches(NamedTuple):
    idx2: torch.Tensor      # (..., N0) match into set 1, -1 if none
    score: torch.Tensor     # (..., N0) assignment confidence
    mask: torch.Tensor      # (..., N0) bool


def extract_matches(
    log_assign: torch.Tensor,
    valid0: torch.Tensor,
    valid1: torch.Tensor,
    threshold: float = 0.1,
) -> LightGlueMatches:
    """Mutual argmax over the padded assignment matrix (..., N0, N1); of
    equal scores the lower index wins, as jnp.argmax picks."""
    scores = torch.exp(log_assign)
    scores = torch.where(valid0[..., :, None] & valid1[..., None, :], scores, 0.0)
    nn0 = argmax_first(scores, -1)
    nn1 = argmax_first(scores, -2)
    rows = torch.arange(scores.shape[-2], device=scores.device)
    mutual = torch.gather(nn1, -1, nn0) == rows
    best = scores.amax(dim=-1)
    ok = mutual & (best > threshold) & valid0
    return LightGlueMatches(idx2=torch.where(ok, nn0, -1), score=best, mask=ok)
