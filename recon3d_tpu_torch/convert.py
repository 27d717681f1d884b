"""Carry the JAX package's state across to the port.

The ported paths have no trained weights: their parameters are the
configuration tree and the camera, and the state that passes between their
stages is the padded keypoint sets and the verified match graph. These
helpers rebuild all of them from plain Python and numpy values (never JAX
objects), so that both packages can run one configuration
(dataclasses.asdict of a recon3d_tpu ReconstructionConfig, np.asarray of
its Camera's K and dist) and hand one another's features to their
matchers.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import ReconstructionConfig
from recon3d_tpu_torch.ops.sift import SiftFeatures


def _from_dict(cls, d: dict):
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise KeyError(f"{cls.__name__} has no fields {sorted(unknown)}")
    kw = {}
    for name, v in d.items():
        t = hints[name]
        if dataclasses.is_dataclass(t):
            v = _from_dict(t, v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[name] = v
    return cls(**kw)


def config_from_dict(d: dict) -> ReconstructionConfig:
    """The port's ReconstructionConfig from dataclasses.asdict of the JAX
    one (or any nested dict of the same fields)."""
    return _from_dict(ReconstructionConfig, d)


def camera_from_numpy(K, dist=None) -> Camera:
    """The port's Camera from a (3, 3) K and optional (5,) distortion."""
    return Camera.from_matrix(np.array(K, np.float32),
                              None if dist is None else np.array(dist, np.float32))


def poses_from_numpy(
    Rs, ts, ids: Optional[Sequence[int]] = None
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """{id: (R (3,3) float32, t (3,) float32)}, the pose dict that
    PatchMatchMVS.reconstruct and the CLI use; ids default to 0..V-1."""
    Rs = np.asarray(Rs, np.float32)
    ts = np.asarray(ts, np.float32).reshape(len(Rs), 3)
    ids = range(len(Rs)) if ids is None else ids
    return {int(i): (Rs[k], ts[k]) for k, i in enumerate(ids)}


_SIFT_DTYPES = {"xy": np.float32, "scale": np.float32, "angle": np.float32,
                "response": np.float32, "desc": np.float32, "valid": np.bool_}


def sift_features_from_numpy(arrays: Dict[str, np.ndarray], device="cpu") -> SiftFeatures:
    """The port's SiftFeatures from a dict of numpy arrays keyed by field
    (xy, scale, angle, response, desc, valid), for one image (K, ...) or a
    stacked batch (V, K, ...): np.asarray of each field of the JAX
    extractor's SiftFeatures."""
    missing = set(_SIFT_DTYPES) - set(arrays)
    if missing:
        raise KeyError(f"SiftFeatures fields missing: {sorted(missing)}")
    return SiftFeatures(**{
        name: torch.from_numpy(np.array(arrays[name], dtype)).to(device)
        for name, dtype in _SIFT_DTYPES.items()
    })


def sift_features_to_numpy(feats: SiftFeatures) -> Dict[str, np.ndarray]:
    """The reverse: a dict of numpy arrays, which recon3d_tpu's SiftFeatures
    takes field by field (jnp.asarray of each)."""
    return {name: getattr(feats, name).detach().cpu().numpy() for name in _SIFT_DTYPES}


def matches_from_numpy(
    matches: Dict[Tuple[int, int], Dict[str, np.ndarray]]
) -> Dict[Tuple[int, int], Dict[str, np.ndarray]]:
    """The `matches` dictionary of SfMPipeline, {(i, j): {idx1, idx2, F, n
    [, aux]}}, normalised to the port's types: int64 keypoint indices,
    a float32 (3, 3) F, and a Python int n."""
    out = {}
    for (i, j), m in matches.items():
        idx1 = np.asarray(m["idx1"], np.int64)
        idx2 = np.asarray(m["idx2"], np.int64)
        if idx1.shape != idx2.shape or idx1.ndim != 1:
            raise ValueError(f"pair {(i, j)}: idx1 and idx2 must be 1-D and equally long")
        entry = dict(idx1=idx1, idx2=idx2, F=np.asarray(m["F"], np.float32).reshape(3, 3),
                     n=int(m.get("n", len(idx1))))
        if m.get("aux"):
            entry["aux"] = True
        out[(int(i), int(j))] = entry
    return out
