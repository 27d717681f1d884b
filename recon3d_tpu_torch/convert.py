"""Carry the JAX package's state across to the port.

The dense-from-known-poses path has no trained weights: its parameters are
the configuration tree and the camera. These helpers rebuild them from
plain Python and numpy values, so that both packages can run one
configuration (dataclasses.asdict of a recon3d_tpu ReconstructionConfig,
np.asarray of its Camera's K and dist).
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import ReconstructionConfig


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
