"""State dicts in the public SuperPoint and LightGlue layouts, and torch
forwards of the official blocks, for the weight-conversion tests and
chip_smoke.py (torch only: no jax).

The layouts are those of the published checkpoints (magicleap SuperPoint,
cvg/LightGlue), as tests/test_weights.py builds them: LightGlue's fused
self-attention Wqkv laid out (heads, head_dim, 3), a shared cross-attention
to_qk, Sequential(Linear, LayerNorm, GELU, Linear) FFNs, per-layer
log_assignment heads and token_confidence heads. Values are drawn from a
seeded generator and rounded to float16, so that a checkpoint written with
save_params_npz (float16 storage) holds exactly the same weights.
"""

import torch
import torch.nn.functional as F


def _draw(seed: int, scale: float):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape):
        return (torch.randn(*shape, generator=gen) * scale).half().float()

    return r


def lightglue_state_dict(seed: int = 0, layers: int = 9, dim: int = 256, heads: int = 4,
                         legacy_names: bool = False) -> dict:
    """A public LightGlue state dict (small weights keep activations O(1)
    through the residual layers, as a trained checkpoint's are)."""
    dh = dim // heads
    r = _draw(seed, 0.05)
    sd = {"posenc.Wr.weight": r(dh // 2, 2)}
    for i in range(layers):
        sp = f"self_attn.{i}" if legacy_names else f"transformers.{i}.self_attn"
        cp = f"cross_attn.{i}" if legacy_names else f"transformers.{i}.cross_attn"
        sd[f"{sp}.Wqkv.weight"] = r(3 * dim, dim)
        sd[f"{sp}.Wqkv.bias"] = r(3 * dim)
        sd[f"{sp}.out_proj.weight"] = r(dim, dim)
        sd[f"{sp}.out_proj.bias"] = r(dim)
        for nm in ("to_qk", "to_v", "to_out"):
            sd[f"{cp}.{nm}.weight"] = r(dim, dim)
            sd[f"{cp}.{nm}.bias"] = r(dim)
        for p in (sp, cp):
            sd[f"{p}.ffn.0.weight"] = r(2 * dim, 2 * dim)
            sd[f"{p}.ffn.0.bias"] = r(2 * dim)
            sd[f"{p}.ffn.1.weight"] = (1.0 + 0.1 * r(2 * dim)).half().float()
            sd[f"{p}.ffn.1.bias"] = (0.1 * r(2 * dim)).half().float()
            sd[f"{p}.ffn.3.weight"] = r(dim, 2 * dim)
            sd[f"{p}.ffn.3.bias"] = r(dim)
    for i in range(layers):
        sd[f"log_assignment.{i}.final_proj.weight"] = r(dim, dim)
        sd[f"log_assignment.{i}.final_proj.bias"] = r(dim)
        sd[f"log_assignment.{i}.matchability.weight"] = r(1, dim)
        sd[f"log_assignment.{i}.matchability.bias"] = r(1)
    for i in range(layers - 1):   # early-exit heads, which the port does not use
        sd[f"token_confidence.{i}.token.0.weight"] = r(1, dim)
        sd[f"token_confidence.{i}.token.0.bias"] = r(1)
    return sd


def superpoint_state_dict(seed: int = 1, descriptor_dim: int = 256) -> dict:
    """A public SuperPoint state dict."""
    r = _draw(seed, 0.1)
    chans = {"conv1a": (64, 1), "conv1b": (64, 64), "conv2a": (64, 64), "conv2b": (64, 64),
             "conv3a": (128, 64), "conv3b": (128, 128), "conv4a": (128, 128),
             "conv4b": (128, 128), "convPa": (256, 128), "convDa": (256, 128)}
    sd = {}
    for name, (o, i) in chans.items():
        sd[f"{name}.weight"] = r(o, i, 3, 3)
        sd[f"{name}.bias"] = r(o)
    sd["convPb.weight"] = r(65, 256, 1, 1)
    sd["convPb.bias"] = r(65)
    sd["convDb.weight"] = r(descriptor_dim, 256, 1, 1)
    sd["convDb.bias"] = r(descriptor_dim)
    return sd


def lightglue_reference(sd, desc0, desc1, xy0, xy1, layers: int = 9, heads: int = 4):
    """The official LightGlue forward (lightglue/lightglue.py) of one pair
    from a state dict: interleaved (heads, head_dim, 3) Wqkv, rotate_half
    rotary with a repeat_interleave(2) Fourier encoding, shared cross
    to_qk, the last log_assignment head. Returns (log-assignment,
    matchability0, matchability1)."""
    D = desc0.shape[-1]
    DH = D // heads

    def lin(x, name):
        return x @ sd[f"{name}.weight"].T + sd[f"{name}.bias"]

    def posenc(xy):
        proj = xy @ sd["posenc.Wr.weight"].T
        return torch.stack([torch.cos(proj), torch.sin(proj)], 0).repeat_interleave(2, dim=-1)

    def rotate_half(x):
        x1, x2 = x.unflatten(-1, (-1, 2)).unbind(dim=-1)
        return torch.stack((-x2, x1), dim=-1).flatten(start_dim=-2)

    def ffn(y, p):
        y = F.layer_norm(lin(y, f"{p}.ffn.0"), (y.shape[-1],), sd[f"{p}.ffn.1.weight"],
                         sd[f"{p}.ffn.1.bias"])
        return lin(F.gelu(y), f"{p}.ffn.3")

    def self_block(x, enc, p):
        qkv = lin(x, f"{p}.Wqkv").unflatten(-1, (heads, DH, 3)).permute(1, 0, 2, 3)
        q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
        q = q * enc[0] + rotate_half(q) * enc[1]
        k = k * enc[0] + rotate_half(k) * enc[1]
        attn = torch.softmax(q @ k.transpose(-1, -2) / DH ** 0.5, dim=-1)
        msg = lin((attn @ v).permute(1, 0, 2).reshape(-1, D), f"{p}.out_proj")
        return x + ffn(torch.cat([x, msg], -1), p)

    def split(t):
        return t.unflatten(-1, (heads, DH)).permute(1, 0, 2)

    def cross_block(x0, x1, p):
        s = DH ** -0.5
        qk0, qk1 = split(lin(x0, f"{p}.to_qk")), split(lin(x1, f"{p}.to_qk"))
        v0, v1 = split(lin(x0, f"{p}.to_v")), split(lin(x1, f"{p}.to_v"))
        sim = (qk0 * s ** 0.5) @ (qk1 * s ** 0.5).transpose(-1, -2)
        m0 = lin((torch.softmax(sim, dim=-1) @ v1).permute(1, 0, 2).reshape(-1, D),
                 f"{p}.to_out")
        m1 = lin((torch.softmax(sim.transpose(-2, -1), dim=-1) @ v0).permute(1, 0, 2)
                 .reshape(-1, D), f"{p}.to_out")
        return x0 + ffn(torch.cat([x0, m0], -1), p), x1 + ffn(torch.cat([x1, m1], -1), p)

    x0, x1 = desc0, desc1
    enc0, enc1 = posenc(xy0), posenc(xy1)
    for i in range(layers):
        x0 = self_block(x0, enc0, f"transformers.{i}.self_attn")
        x1 = self_block(x1, enc1, f"transformers.{i}.self_attn")
        x0, x1 = cross_block(x0, x1, f"transformers.{i}.cross_attn")
    la = f"log_assignment.{layers - 1}"
    f0 = lin(x0, f"{la}.final_proj") / D ** 0.25
    f1 = lin(x1, f"{la}.final_proj") / D ** 0.25
    sim = f0 @ f1.T
    z0 = lin(x0, f"{la}.matchability")[:, 0]
    z1 = lin(x1, f"{la}.matchability")[:, 0]
    scores = (torch.log_softmax(sim, 1) + torch.log_softmax(sim, 0)
              + F.logsigmoid(z0)[:, None] + F.logsigmoid(z1)[None, :])
    return scores, torch.sigmoid(z0), torch.sigmoid(z1)


def superpoint_reference(sd, img):
    """The official SuperPoint forward (magicleap superpoint.py) of one (H,
    W) image: logits (H/8, W/8, 65) and unit descriptors (H/8, W/8, D)."""

    def conv(x, name, relu=True, pad=1):
        x = F.conv2d(x, sd[f"{name}.weight"], sd[f"{name}.bias"], padding=pad)
        return F.relu(x) if relu else x

    x = img[None, None]
    for block in ("1", "2", "3"):
        x = F.max_pool2d(conv(conv(x, f"conv{block}a"), f"conv{block}b"), 2, 2)
    x = conv(conv(x, "conv4a"), "conv4b")
    logits = conv(conv(x, "convPa"), "convPb", relu=False, pad=0)
    desc = F.normalize(conv(conv(x, "convDa"), "convDb", relu=False, pad=0), p=2, dim=1)
    return logits[0].permute(1, 2, 0), desc[0].permute(1, 2, 0)
