"""Plain reference of SuperPoint and LightGlue: their forward passes in
plain torch, in float32 with TF32 off, for holding the port's networks
(neural/superpoint.py, neural/lightglue.py, neural/matcher.py) to an
independent computation.

It imports nothing of the port: it reads the same .npz checkpoints (Flax
layout, 'params/<module>/<leaf>', float16) through its own key mapping,
computes with functions of torch alone, one image or one pair at a time,
and samples the descriptors with its own bilinear gather. The neural SfM
cell's check (benchmark/jobs/sfm_neural.py) and the port's tests
(tests/test_torch_neural_reference*.py) hold the networks to it.

SuperPoint (DeTone, Malisiewicz and Rabinovich, CVPR Workshops 2018):
VGG encoder, a 65-way detector head (8x8 cells and a dustbin) with softmax
and depth-to-space, a 256-d descriptor head. LightGlue (Lindenberger,
Sarlin and Pollefeys, ICCV 2023): input projection, L layers of
self-attention with a 2-D rotary encoding and bidirectional
cross-attention, each followed by a message MLP, then a matchability head
and the log double softmax, and matches by mutual argmax.

Departures from the papers, as the repository's networks define them:
- SuperPoint: NMS keeps a score equal to the maximum of its (2r+1)^2
  window (one max-pool, not the published iterative suppression); the
  keypoints are the top-k at a fixed capacity with a validity mask
  (score above the threshold), equal scores by ascending index, none
  within 4 pixels of the border; each is refined by a 1-D quadratic fit
  per axis on the score map (offset clamped to +-0.5 pixel); descriptors
  are normalised as x * rsqrt(|x|^2 + 1e-8) on the coarse map, sampled
  bilinearly at ((x + 0.5) / 8 - 0.5, (y + 0.5) / 8 - 0.5) and normalised
  again.
- LightGlue: positions are centred and divided by half the longer side;
  the rotary encoding is cos/sin of xy @ freqs (a learned (2, Dh/2)
  matrix) applied to the two halves of each head; each direction of self-
  and cross-attention has its own q, k, v and output projections; padded
  slots are masked with -1e9 in the attention logits and in the
  similarity; there is no adaptive depth and no point pruning, so the
  published early exit is left out and every layer runs over every slot
  (more work, not less); matches are the mutual argmax of exp of the
  log-assignment over valid slots, above a threshold.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

ENCODER = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b")
BORDER = 4


@contextlib.contextmanager
def float32_exact() -> Iterator[None]:
    """Matrix products and convolutions in full float32 (TF32 off) inside
    the block; the previous settings come back after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def load_params(source: Union[str, Path, Mapping[str, np.ndarray]], device="cpu"
                ) -> Dict[str, torch.Tensor]:
    """The parameters of a checkpoint as float32 tensors on `device`, keyed
    '<module>/<leaf>' ('conv1a/kernel', 'layer0/self_attn0/to_q/bias', ...):
    an .npz file of the Flax layout or a mapping of its keys to arrays. Conv
    kernels stay HWIO and dense kernels (in, out), as the file holds them."""
    if isinstance(source, (str, Path)):
        with np.load(source) as z:
            source = {k: z[k] for k in z.files}
    out = {}
    for key, arr in source.items():
        name = key[len("params/"):] if key.startswith("params/") else key
        out[name] = torch.from_numpy(np.asarray(arr, np.float32)).to(device)
    return out


def _cast(params: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
    return {k: v.to(dtype) for k, v in params.items()}


def _conv(x: torch.Tensor, params, name: str) -> torch.Tensor:
    """x (1, C, H, W); the HWIO kernel as OIHW, 'same' padding."""
    w = params[f"{name}/kernel"].permute(3, 2, 0, 1)
    return F.conv2d(x, w, params[f"{name}/bias"], padding=w.shape[-1] // 2)


# -- SuperPoint -------------------------------------------------------------------------------


def superpoint_maps(params, image: torch.Tensor, dtype=torch.float32
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """image (H, W) grayscale in [0, 1], cropped to multiples of 8 ->
    (prob (H8, W8): the detector's softmax without the dustbin, 8x8 cells
    laid out in place; desc (Hc, Wc, D): the normalised coarse
    descriptors), in `dtype`."""
    p = _cast(params, dtype)
    H8, W8 = (image.shape[0] // 8) * 8, (image.shape[1] // 8) * 8
    with float32_exact():
        x = image[:H8, :W8].to(dtype)[None, None]
        for i, name in enumerate(ENCODER):
            x = F.relu(_conv(x, p, name))
            if i in (1, 3, 5):
                x = F.max_pool2d(x, 2)
        logits = _conv(F.relu(_conv(x, p, "convPa")), p, "convPb")[0]       # (65, Hc, Wc)
        desc = _conv(F.relu(_conv(x, p, "convDa")), p, "convDb")[0]         # (D, Hc, Wc)
    desc = desc * torch.rsqrt((desc * desc).sum(0, keepdim=True) + 1e-8)
    prob = torch.softmax(logits, dim=0)[:64]
    Hc, Wc = prob.shape[1:]
    prob = prob.reshape(8, 8, Hc, Wc).permute(2, 0, 3, 1).reshape(Hc * 8, Wc * 8)
    return prob, desc.permute(1, 2, 0)


def nms(prob: torch.Tensor, radius: int) -> torch.Tensor:
    """Scores equal to the maximum of their (2r+1)^2 window, else 0."""
    window = F.max_pool2d(prob[None, None], 2 * radius + 1, stride=1, padding=radius)[0, 0]
    return torch.where(prob >= window, prob, torch.zeros_like(prob))


def select_keypoints(prob: torch.Tensor, max_keypoints: int, detection_threshold: float,
                     nms_radius: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(xy (K, 2) x, y pixels, refined; score (K,); valid (K,)): the K
    highest scores after NMS and away from the border, equal scores by
    ascending index."""
    H, W = prob.shape
    s = nms(prob, nms_radius)
    keep = torch.zeros_like(s, dtype=torch.bool)
    keep[BORDER:H - BORDER, BORDER:W - BORDER] = True
    s = torch.where(keep, s, torch.zeros_like(s)).reshape(-1)
    order = torch.sort(s, descending=True, stable=True).indices[:max_keypoints]
    score = s[order]
    yi, xi = order // W, order % W

    def offset(before, at, after):
        d = 0.5 * (after - before)
        d2 = after - 2.0 * at + before
        off = torch.where(d2 < -1e-12, -d / torch.clamp(d2, max=-1e-12), torch.zeros_like(d))
        return torch.clamp(off, -0.5, 0.5)

    p = prob.to(torch.float32)          # positions in float32 whatever the map's type
    at = p[yi, xi]
    x = xi.to(torch.float32) + offset(p[yi, (xi - 1).clamp(min=0)], at,
                                      p[yi, (xi + 1).clamp(max=W - 1)])
    y = yi.to(torch.float32) + offset(p[(yi - 1).clamp(min=0), xi], at,
                                      p[(yi + 1).clamp(max=H - 1), xi])
    return torch.stack([x, y], -1), score, score > detection_threshold


def sample_descriptors(desc: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """desc (Hc, Wc, D) at pixels xy (K, 2): bilinear in cell units, then
    unit length. Points off the map get zeros."""
    Hc, Wc, D = desc.shape
    cx = (xy[:, 0] + 0.5) / 8.0 - 0.5
    cy = (xy[:, 1] + 0.5) / 8.0 - 0.5
    inside = (cx >= 0) & (cx <= Wc - 1) & (cy >= 0) & (cy <= Hc - 1)
    cx = torch.where(inside, cx, torch.zeros_like(cx))
    cy = torch.where(inside, cy, torch.zeros_like(cy))
    x0, y0 = cx.floor(), cy.floor()
    fx, fy = (cx - x0)[:, None], (cy - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=Wc - 1), (y0 + 1).clamp(max=Hc - 1)
    out = (desc[y0, x0] * (1 - fx) * (1 - fy) + desc[y0, x1] * fx * (1 - fy)
           + desc[y1, x0] * (1 - fx) * fy + desc[y1, x1] * fx * fy)
    out = torch.where(inside[:, None], out, torch.zeros_like(out))
    return out / torch.linalg.norm(out, dim=-1, keepdim=True).clamp(min=1e-12)


def superpoint(params, image: torch.Tensor, max_keypoints: int = 2048,
               detection_threshold: float = 0.0005, nms_radius: int = 4,
               dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """SuperPoint on one image: {prob, desc_map, xy, score, desc, valid}."""
    prob, desc_map = superpoint_maps(params, image, dtype)
    xy, score, valid = select_keypoints(prob, max_keypoints, detection_threshold, nms_radius)
    return {"prob": prob, "desc_map": desc_map, "xy": xy, "score": score,
            "desc": sample_descriptors(desc_map, xy), "valid": valid}


# -- LightGlue --------------------------------------------------------------------------------


def normalize_keypoints(xy: torch.Tensor, hw) -> torch.Tensor:
    """Pixels to about [-1, 1]: centred, over half the longer side."""
    h, w = float(hw[0]), float(hw[1])
    centre = torch.tensor([w / 2.0, h / 2.0], dtype=xy.dtype, device=xy.device)
    return (xy - centre) / (max(w, h) / 2.0)


def _dense(x, p, name):
    return x @ p[f"{name}/kernel"] + p[f"{name}/bias"]


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (heads, N, Dh): each half of a head rotated against the other."""
    half = x.shape[-1] // 2
    swapped = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + swapped * sin


def _attention(p, name, q_in, kv_in, kv_valid, heads, rotary=None):
    N, D = q_in.shape
    Dh = D // heads

    def split(t):
        return t.reshape(t.shape[0], heads, Dh).transpose(0, 1)      # (heads, N, Dh)

    q = split(_dense(q_in, p, f"{name}/to_q"))
    k = split(_dense(kv_in, p, f"{name}/to_k"))
    v = split(_dense(kv_in, p, f"{name}/to_v"))
    if rotary is not None:
        q, k = _rotate(q, *rotary[0]), _rotate(k, *rotary[1])
    logits = q @ k.transpose(-1, -2) / float(Dh) ** 0.5
    logits = logits.masked_fill(~kv_valid[None, None, :], -1e9)
    out = (torch.softmax(logits, dim=-1) @ v).transpose(0, 1).reshape(N, D)
    return _dense(out, p, f"{name}/to_out")


def _update(p, name, x, message):
    y = _dense(torch.cat([x, message], dim=-1), p, f"{name}/ffn1")
    y = F.layer_norm(y, y.shape[-1:], p[f"{name}/ln/scale"], p[f"{name}/ln/bias"], eps=1e-5)
    return x + _dense(F.gelu(y), p, f"{name}/ffn2")


def lightglue(params, desc0: torch.Tensor, desc1: torch.Tensor, xy0: torch.Tensor,
              xy1: torch.Tensor, valid0: torch.Tensor, valid1: torch.Tensor, hw,
              num_layers: int = 9, num_heads: int = 4, dtype=torch.float32) -> torch.Tensor:
    """LightGlue on one pair of padded sets: desc (N, D), xy (N, 2) pixels
    of an image of size hw = (h, w), valid (N,) -> the log-assignment
    (N0 + 1, N1 + 1), the dustbins in the last column and row, 0 in the
    corner; rows and columns of padded slots are not meaningful."""
    p = _cast(params, dtype)
    with float32_exact():
        x0 = _dense(desc0.to(dtype), p, "input_proj")
        x1 = _dense(desc1.to(dtype), p, "input_proj")
        freqs = p["rotary_freqs"]

        def rotary(xy):
            ang = normalize_keypoints(xy.to(dtype), hw) @ freqs
            ang = torch.cat([ang, ang], dim=-1)[None]                      # (1, N, Dh)
            return torch.cos(ang), torch.sin(ang)

        r0, r1 = rotary(xy0), rotary(xy1)
        for i in range(num_layers):
            name = f"layer{i}"
            m0 = _attention(p, f"{name}/self_attn0", x0, x0, valid0, num_heads, (r0, r0))
            m1 = _attention(p, f"{name}/self_attn1", x1, x1, valid1, num_heads, (r1, r1))
            x0 = _update(p, f"{name}/self_upd0", x0, m0)
            x1 = _update(p, f"{name}/self_upd1", x1, m1)
            c0 = _attention(p, f"{name}/cross_attn0", x0, x1, valid1, num_heads)
            c1 = _attention(p, f"{name}/cross_attn1", x1, x0, valid0, num_heads)
            x0 = _update(p, f"{name}/cross_upd0", x0, c0)
            x1 = _update(p, f"{name}/cross_upd1", x1, c1)
        D = x0.shape[-1]
        f0 = _dense(x0, p, "final_proj") / D ** 0.25
        f1 = _dense(x1, p, "final_proj") / D ** 0.25
        sim = f0 @ f1.T
        z0 = _dense(x0, p, "matchability")[:, 0]
        z1 = _dense(x1, p, "matchability")[:, 0]
    sim = sim.masked_fill(~valid0[:, None], -1e9).masked_fill(~valid1[None, :], -1e9)
    out = torch.zeros((sim.shape[0] + 1, sim.shape[1] + 1), dtype=sim.dtype, device=sim.device)
    out[:-1, :-1] = (torch.log_softmax(sim, dim=1) + torch.log_softmax(sim, dim=0)
                     + F.logsigmoid(z0)[:, None] + F.logsigmoid(z1)[None, :])
    out[:-1, -1] = F.logsigmoid(-z0)
    out[-1, :-1] = F.logsigmoid(-z1)
    return out


def mutual_matches(log_assign: torch.Tensor, valid0: torch.Tensor, valid1: torch.Tensor,
                   threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx2 (N0,), -1 where none; score (N0,)) from a log-assignment with
    dustbins: the mutual argmax of its probabilities over valid slots (the
    lower index of equal ones), above `threshold`."""
    prob = torch.exp(log_assign[:-1, :-1])
    prob = torch.where(valid0[:, None] & valid1[None, :], prob, torch.zeros_like(prob))
    best0, best1 = prob.amax(dim=1), prob.amax(dim=0)
    rows = torch.arange(prob.shape[0], device=prob.device)
    cols = torch.arange(prob.shape[1], device=prob.device)
    big = prob.shape[0] + prob.shape[1]
    nn0 = torch.where(prob == best0[:, None], cols[None, :], big).amin(dim=1)
    nn1 = torch.where(prob == best1[None, :], rows[:, None], big).amin(dim=0)
    ok = (nn1[nn0] == rows) & (best0 > threshold) & valid0
    return torch.where(ok, nn0, -1), best0
