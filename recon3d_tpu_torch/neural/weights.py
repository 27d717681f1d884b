"""Weights of SuperPoint and LightGlue, carried across in both directions.

PyTorch port of recon3d_tpu/neural/weights.py:
- `save_params_npz(module, path)` writes the JAX package's checkpoint
  format, the flat '/'-keyed Flax parameters stored as float16
  (`params/conv1a/kernel`, `params/layer0/self_attn0/to_q/kernel`, ...),
  so that the JAX `load_params_npz` reads a network the port trained;
  `load_params_npz(path, template)` reads the JAX package's files (or a
  public torch checkpoint) into a module.
- `load_superpoint_torch` and `load_lightglue_torch` read the public torch
  checkpoints (magicleap SuperPoint, cvg/LightGlue) with the JAX mapping:
  they build the flat Flax parameters, which then go through
  convert.flax_to_state_dict like any .npz file.
- `flax_init_` draws a network's parameters as Flax initialises them.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from recon3d_tpu_torch.convert import flax_to_state_dict, read_params_npz
from recon3d_tpu_torch.neural.lightglue import LightGlueNet
from recon3d_tpu_torch.neural.superpoint import SuperPointNet

# The standard deviation of a standard normal truncated at +-2, by which
# Flax's lecun_normal rescales its draws (jax.nn.initializers.
# variance_scaling, "truncated_normal").
TRUNCATED_NORMAL_STD = 0.87962566103423978


def flax_init_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Draw the parameters of `module` in place as Flax initialises
    nn.Conv and nn.Dense (lecun_normal kernels: a normal truncated at +-2
    and rescaled to the std 1/sqrt(fan_in), fan_in = in * kh * kw), zero
    biases, LayerNorm scales of one, and LightGlue's rotary frequencies
    from normal(1.0) (recon3d_tpu/neural/lightglue.py:140-143).

    The draws come from `generator`, a CPU generator, and are copied to
    the parameters' device; they follow jax.random's distribution, not its
    numbers."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "rotary_freqs":
                p.copy_(torch.randn(p.shape, generator=generator))
            elif leaf == "bias":
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                fan_in = p[0].numel()
                w = torch.nn.init.trunc_normal_(torch.empty(p.shape), 0.0, 1.0, -2.0, 2.0,
                                                generator=generator)
                p.copy_(w * (fan_in ** -0.5 / TRUNCATED_NORMAL_STD))
    return module


def state_dict_to_flax(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The flat '/'-keyed Flax parameters of `module`, the inverse of
    convert.flax_to_state_dict: conv weights OIHW -> HWIO and nn.Linear's
    (out, in) -> (in, out) as `kernel`, LayerNorm's `weight` as `scale`,
    other leaves (LightGlue's rotary_freqs) under their own name."""
    flat = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        arr = p.detach().cpu().numpy().copy()   # not a view of a CPU parameter
        if leaf == "weight" and arr.ndim == 4:
            leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
        elif leaf == "weight" and arr.ndim == 2:
            leaf, arr = "kernel", arr.T
        elif leaf == "weight":
            leaf = "scale"
        flat["/".join(["params", *path, leaf])] = np.ascontiguousarray(arr)
    return flat


def save_params_npz(module: torch.nn.Module, path) -> None:
    """Write `module` as a save_params_npz checkpoint of the JAX package:
    the Flax names and layouts of state_dict_to_flax, float32 stored as
    float16 (recon3d_tpu/neural/weights.py:16-28)."""
    out = {k: v.astype(np.float16) if v.dtype == np.float32 else v
           for k, v in state_dict_to_flax(module).items()}
    np.savez_compressed(path, **out)


def load_params_npz(path, template: torch.nn.Module) -> torch.nn.Module:
    """Load a checkpoint (a save_params_npz .npz or a public torch .pth)
    into the module `template` in place, through flax_to_state_dict: every
    key of the file consumed, every parameter set. Returns the module, as
    the JAX function returns the filled parameter tree."""
    flat = read_params_npz(path, template)
    template.load_state_dict(flax_to_state_dict(flat, template), strict=True)
    return template


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, arr in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = arr
    return tree


def _flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for name, v in tree.items():
        key = f"{prefix}/{name}" if prefix else name
        flat.update(_flatten(v, key) if isinstance(v, dict) else {key: v})
    return flat


def _load_torch_state(path) -> Dict[str, np.ndarray]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


_SUPERPOINT_CONVS = (
    "conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b",
    "convPa", "convPb", "convDa", "convDb",
)


def superpoint_flax_from_torch(path, module: SuperPointNet, strict: bool = True
                               ) -> Dict[str, np.ndarray]:
    """The flat Flax parameters of `module` with the public SuperPoint
    checkpoint's convolutions in place (recon3d_tpu/neural/weights.py:73).

    strict (default): every conv present with the module's shape, else
    KeyError / ValueError (a 'module.'-prefixed layout fails loudly);
    strict=False leaves a missing conv as the module has it."""
    sd = _load_torch_state(path)
    out = _nest(state_dict_to_flax(module))["params"]
    for n in _SUPERPOINT_CONVS:
        if f"{n}.weight" not in sd:
            if strict:
                raise KeyError(f"SuperPoint checkpoint {path} missing {n}.weight "
                               f"(found keys like {sorted(sd)[:3]}...)")
            continue
        # torch conv (O, I, kh, kw) -> Flax (kh, kw, I, O)
        conv = {"kernel": np.transpose(sd[f"{n}.weight"], (2, 3, 1, 0)),
                "bias": sd[f"{n}.bias"]}
        if strict:
            for leaf in ("kernel", "bias"):
                want, got = out[n][leaf].shape, conv[leaf].shape
                if want != got:
                    raise ValueError(f"SuperPoint checkpoint {path} shape mismatch at "
                                     f"{n}.{leaf}: {got} vs {want}")
        out[n] = conv
    return _flatten({"params": out})


def _rotary_perm(dh: int) -> np.ndarray:
    """Head-dim permutation from the official interleaved rotary pairing
    ((2i, 2i+1)) to the half-split one of neural/lightglue.apply_rotary
    ((i, i + dh/2)): new[i] = old[2i], new[i + dh/2] = old[2i + 1]. q.k is
    invariant to a permutation shared by q and k, so the converted weights
    give the official attention logits."""
    return np.concatenate([np.arange(0, dh, 2), np.arange(1, dh, 2)])


def _headed(w: np.ndarray, heads: int, perm) -> np.ndarray:
    """(d_out, d_in) torch Linear weight -> Flax kernel (d_in, d_out), the
    output rows of each head permuted for the rotary layout."""
    if perm is None:
        return w.T
    d_out = w.shape[0]
    return w.reshape(heads, d_out // heads, -1)[:, perm].reshape(d_out, -1).T


def _headed_bias(b: np.ndarray, heads: int, perm) -> np.ndarray:
    if perm is None:
        return b
    return b.reshape(heads, b.shape[0] // heads)[:, perm].reshape(-1)


def lightglue_flax_from_torch(path, module: LightGlueNet, strict: bool = True
                              ) -> Dict[str, np.ndarray]:
    """The flat Flax parameters of `module` from a public LightGlue
    checkpoint (cvg/LightGlue), mapped as recon3d_tpu/neural/weights.py:150
    maps it:
      - `transformers.{i}.self_attn.Wqkv`: one fused projection whose output
        is laid out (heads, head_dim, 3), interleaved, not [q|k|v] blocks;
        the q and k rows permuted by _rotary_perm;
      - `transformers.{i}.cross_attn.to_qk`: one projection for q and k;
      - per-layer weights shared by both sets (our *0 / *1 modules);
      - `posenc.Wr.weight`.T as rotary_freqs;
      - a missing `input_proj` (Identity in the public config) as the
        identity matrix;
      - legacy `self_attn.{i}.` / `cross_attn.{i}.` names renamed;
      - only the last `log_assignment` head (final_proj, matchability).
    Keys the static-depth network does not use (token_confidence.*, the
    earlier assignment heads) are skipped.

    strict (default) raises KeyError / ValueError on any missing or
    mis-shaped head; strict=False returns the module's parameters as they
    were, as the JAX loader returns its template."""
    sd = {}
    for k, v in _load_torch_state(path).items():
        k = re.sub(r"^self_attn\.(\d+)\.", r"transformers.\1.self_attn.", k)
        k = re.sub(r"^cross_attn\.(\d+)\.", r"transformers.\1.cross_attn.", k)
        sd[k] = v
    params = _nest(state_dict_to_flax(module))["params"]
    n_layers = len([k for k in params if k.startswith("layer")])

    def take(key):
        if key not in sd:
            raise KeyError(f"lightglue checkpoint {path} missing {key}")
        return sd[key]

    def shaped(arr, like, key):
        if arr.shape != like.shape:
            raise ValueError(f"lightglue checkpoint {path} shape mismatch at {key}: "
                             f"{arr.shape} vs {like.shape}")
        return arr.astype(like.dtype)

    def assign(dst: dict, name: str, kernel, bias, key: str):
        dst[name] = {"kernel": shaped(kernel, dst[name]["kernel"], key + ".kernel"),
                     "bias": shaped(bias, dst[name]["bias"], key + ".bias")}

    try:
        out = dict(params)
        dim = params["final_proj"]["kernel"].shape[0]
        dh2 = params["rotary_freqs"].shape[1]
        heads = dim // (2 * dh2)
        perm = _rotary_perm(2 * dh2)

        out["rotary_freqs"] = shaped(take("posenc.Wr.weight").T, params["rotary_freqs"],
                                     "rotary_freqs")
        if "input_proj.weight" in sd:
            assign(out, "input_proj", take("input_proj.weight").T, take("input_proj.bias"),
                   "input_proj")
        else:
            assign(out, "input_proj", np.eye(dim, dtype=np.float32),
                   np.zeros(dim, np.float32), "input_proj(identity)")

        for i in range(n_layers):
            layer = dict(out[f"layer{i}"])
            sp, cp = f"transformers.{i}.self_attn", f"transformers.{i}.cross_attn"
            Wqkv = take(f"{sp}.Wqkv.weight")                       # (3d, d)
            bqkv = take(f"{sp}.Wqkv.bias")
            Wh = Wqkv.reshape(heads, -1, 3, Wqkv.shape[1])          # (H, dh, 3, d)
            bh = bqkv.reshape(heads, -1, 3)                         # (H, dh, 3)
            qkv = {}
            for t, nm in enumerate(("to_q", "to_k", "to_v")):
                p = perm if nm != "to_v" else None
                w_t = Wh[:, :, t, :].reshape(heads * Wh.shape[1], -1)
                qkv[nm] = (_headed(w_t, heads, p), _headed_bias(bh[:, :, t].reshape(-1), heads, p))
            for side in ("self_attn0", "self_attn1"):
                sub = dict(layer[side])
                for nm, (w_t, b_t) in qkv.items():
                    assign(sub, nm, w_t, b_t, f"{sp}.Wqkv[{nm}]")
                assign(sub, "to_out", take(f"{sp}.out_proj.weight").T,
                       take(f"{sp}.out_proj.bias"), f"{sp}.out_proj")
                layer[side] = sub
            # cross attention: to_qk feeds q and k (no rotary, no permutation)
            for side in ("cross_attn0", "cross_attn1"):
                sub = dict(layer[side])
                for nm, theirs in (("to_q", "to_qk"), ("to_k", "to_qk"), ("to_v", "to_v"),
                                   ("to_out", "to_out")):
                    assign(sub, nm, take(f"{cp}.{theirs}.weight").T,
                           take(f"{cp}.{theirs}.bias"), f"{cp}.{theirs}")
                layer[side] = sub
            # residual FFNs: Sequential(Linear, LayerNorm, GELU, Linear)
            for ours, theirs in (("self_upd0", sp), ("self_upd1", sp),
                                 ("cross_upd0", cp), ("cross_upd1", cp)):
                sub = dict(layer[ours])
                assign(sub, "ffn1", take(f"{theirs}.ffn.0.weight").T,
                       take(f"{theirs}.ffn.0.bias"), f"{theirs}.ffn.0")
                sub["ln"] = {
                    "scale": shaped(take(f"{theirs}.ffn.1.weight"), sub["ln"]["scale"],
                                    f"{theirs}.ffn.1.weight"),
                    "bias": shaped(take(f"{theirs}.ffn.1.bias"), sub["ln"]["bias"],
                                   f"{theirs}.ffn.1.bias"),
                }
                assign(sub, "ffn2", take(f"{theirs}.ffn.3.weight").T,
                       take(f"{theirs}.ffn.3.bias"), f"{theirs}.ffn.3")
                layer[ours] = sub
            out[f"layer{i}"] = layer

        la = f"log_assignment.{n_layers - 1}"
        assign(out, "final_proj", take(f"{la}.final_proj.weight").T,
               take(f"{la}.final_proj.bias"), f"{la}.final_proj")
        assign(out, "matchability", take(f"{la}.matchability.weight").T,
               take(f"{la}.matchability.bias"), f"{la}.matchability")
    except (KeyError, ValueError):
        if strict:
            raise
        out = params
    return _flatten({"params": out})


def flax_from_torch(path, module: torch.nn.Module, strict: bool = True
                    ) -> Dict[str, np.ndarray]:
    """The flat Flax parameters of a torch checkpoint for `module`, a
    SuperPointNet or a LightGlueNet."""
    if isinstance(module, SuperPointNet):
        return superpoint_flax_from_torch(path, module, strict)
    if isinstance(module, LightGlueNet):
        return lightglue_flax_from_torch(path, module, strict)
    raise TypeError(f"no torch checkpoint layout is known for {type(module).__name__}")


def load_superpoint_torch(path, module: SuperPointNet, strict: bool = True) -> SuperPointNet:
    """Load a public SuperPoint .pth into `module` in place."""
    flat = superpoint_flax_from_torch(path, module, strict)
    module.load_state_dict(flax_to_state_dict(flat, module), strict=True)
    return module


def load_lightglue_torch(path, module: LightGlueNet, strict: bool = True) -> LightGlueNet:
    """Load a public LightGlue .pth into `module` in place."""
    flat = lightglue_flax_from_torch(path, module, strict)
    module.load_state_dict(flax_to_state_dict(flat, module), strict=True)
    return module
