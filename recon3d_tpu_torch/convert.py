"""Carry the JAX package's state across to the port.

The parameters of the ported paths are the configuration tree, the camera
and the neural front end's weights; the state that passes between their
stages is the padded keypoint sets, the verified match graph and the
growing reconstruction (poses, points, tracks). These helpers rebuild all
of them from plain Python and numpy values (never JAX objects), so that
both packages can run one configuration (dataclasses.asdict of a
recon3d_tpu ReconstructionConfig, np.asarray of its Camera's K and dist),
share one checkpoint of SuperPoint and LightGlue (the '/'-keyed .npz files
that either package's neural/weights.save_params_npz writes, or a public
torch .pth), hand one
another's features to their matchers and continue one another's
reconstructions.
"""

from __future__ import annotations

import dataclasses
import typing
from pathlib import Path
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


def ba_problem_from_numpy(K, Rs, ts, points, obs_log, kp_table, cam_ids=None):
    """A bundle adjustment problem stated in numpy, as the leading arguments
    of sfm.bundle.bundle_adjust_log: (K (3, 3) float32, {cam_id: (R, t)},
    points (P, 3) float32, log (O, 3) int32 rows (pid, cam_id, kp_id),
    (kp_flat (sumK, 2) float32, kp_off (V+1,) int64)).

    Rs (C, 3, 3) and ts (C, 3) are the poses of `cam_ids` (0..C-1 when not
    given); kp_table is the pipeline's (kp_flat, kp_off)."""
    poses = poses_from_numpy(Rs, ts, cam_ids)
    if len(poses) != len(np.asarray(Rs)):
        raise ValueError("cam_ids must name each pose once")
    log = np.asarray(obs_log)
    if log.ndim != 2 or log.shape[1] != 3:
        raise ValueError("obs_log must be (O, 3) rows of (pid, cam_id, kp_id)")
    kp_flat, kp_off = kp_table
    return (np.array(K, np.float32), poses, np.array(points, np.float32).reshape(-1, 3),
            log.astype(np.int32),
            (np.array(kp_flat, np.float32).reshape(-1, 2), np.array(kp_off, np.int64)))


_SFM_STATE_KEYS = ("matches", "kp_xy", "poses", "registered", "points", "colors",
                   "observations", "kp_to_point")


def sfm_state_to_numpy(pipe) -> dict:
    """The reconstruction state of an SfMPipeline (either package's) as
    plain Python and numpy values: the verified match graph and keypoint
    tables (stage 3), poses {view: (R, t)}, the registered and failed
    sets, points, colours, the per-point observation lists with their
    arrival-order log, the keypoint -> point tables and the 2D-3D
    correspondence index of the unregistered views."""
    return dict(
        matches=matches_from_numpy(pipe.matches),
        kp_xy=[np.array(k, np.float32) for k in pipe.kp_xy],
        poses={int(i): (np.array(R, np.float32), np.array(t, np.float32).reshape(3))
               for i, (R, t) in pipe.poses.items()},
        registered=sorted(int(i) for i in pipe.registered),
        failed=sorted(int(i) for i in pipe.failed),
        points=np.array(pipe.points3d, np.float32).reshape(-1, 3),
        colors=np.array(pipe.point_colors, np.uint8).reshape(-1, 3),
        observations=[[(int(c), int(k)) for c, k in obs] for obs in pipe.observations],
        obs_log=np.array(pipe._obs_log.view(), np.int32).reshape(-1, 3),
        kp_to_point=[np.array(k, np.int64) for k in pipe.kp_to_point],
        corr={int(i): {int(k): int(p) for k, p in c.items()} for i, c in pipe.corr.items()},
    )


def sfm_state_from_numpy(pipe, state: dict) -> None:
    """Carry a reconstruction state (sfm_state_to_numpy of the JAX
    pipeline, or the same keys built by hand) into the port's SfMPipeline
    `pipe`, which must hold its image set and camera already. Without
    `obs_log` the log is rebuilt point by point; without `corr` the
    correspondence index is rebuilt by replaying the observations in log
    order (the order in which the pipeline creates its links). Features are
    not carried: the stages behind the match graph need only their number,
    so a pipeline that has extracted none gets placeholders."""
    missing = set(_SFM_STATE_KEYS) - set(state)
    if missing:
        raise KeyError(f"SfM state fields missing: {sorted(missing)}")
    points = np.array(state["points"], np.float32).reshape(-1, 3)
    colors = np.array(state["colors"], np.uint8).reshape(-1, 3)
    observations = [[(int(c), int(k)) for c, k in obs] for obs in state["observations"]]
    if not len(points) == len(colors) == len(observations):
        raise ValueError("points, colors and observations must be equally long")
    pipe.matches = matches_from_numpy(state["matches"])
    pipe.kp_xy = [np.array(k, np.float32).reshape(-1, 2) for k in state["kp_xy"]]
    pipe._kp_cache = None
    pipe._kp_flat_dev = None
    if len(pipe.features) != len(pipe.kp_xy):
        pipe.features = [None] * len(pipe.kp_xy)
    pipe.poses = {int(i): (np.array(R, np.float32).reshape(3, 3),
                           np.array(t, np.float32).reshape(3))
                  for i, (R, t) in state["poses"].items()}
    pipe.registered = {int(i) for i in state["registered"]}
    pipe.failed = {int(i) for i in state.get("failed", ())}
    pipe.points3d = points
    pipe.point_colors = colors
    pipe.observations = observations
    pipe.kp_to_point = [np.array(k, np.int64) for k in state["kp_to_point"]]
    if len(pipe.kp_to_point) != len(pipe.kp_xy) or any(
            len(a) != len(b) for a, b in zip(pipe.kp_to_point, pipe.kp_xy)):
        raise ValueError("kp_to_point must match kp_xy view by view")
    pipe._build_kp_links()
    pipe._rebuild_obs_log()
    if "obs_log" in state:
        log = np.array(state["obs_log"], np.int32).reshape(-1, 3)
        if len(log) != sum(len(o) for o in observations):
            raise ValueError("obs_log does not hold the observations")
        pipe._obs_log.replace(log)
    if "corr" in state:
        pipe.corr = {int(i): {int(k): int(p) for k, p in c.items()}
                     for i, c in state["corr"].items()}
    else:
        pipe.corr = {}
        for pid, cam, kp in pipe._obs_log.view().tolist():
            pipe._note_kp_link(cam, kp, pid)


def flax_to_state_dict(flat: Dict[str, np.ndarray], module: torch.nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """The state_dict of `module` from the flat '/'-keyed parameters of a
    Flax module ('params/<path>/<leaf>', as save_params_npz stores them).

    Conv kernels go from HWIO to OIHW, Dense kernels from (in, out) to
    nn.Linear's (out, in), LayerNorm's `scale` becomes `weight`, other
    leaves (LightGlue's rotary_freqs) keep their name. Values take the
    dtype of the module's parameter (the checkpoint stores float16; the
    JAX loader restores the template's float32 the same way). Raises
    KeyError when a key of the file matches no parameter or a parameter is
    left unset, ValueError on a shape mismatch."""
    params = dict(module.named_parameters())
    out: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        *path, leaf = parts
        arr = np.asarray(arr)
        if leaf == "kernel":
            leaf = "weight"
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif leaf == "scale":
            leaf = "weight"
        name = ".".join(path + [leaf])
        if name not in params:
            raise KeyError(f"checkpoint parameter {key} matches no parameter of "
                           f"{type(module).__name__} ({name})")
        if tuple(arr.shape) != tuple(params[name].shape):
            raise ValueError(f"checkpoint shape mismatch at {key}: {arr.shape} vs "
                             f"{tuple(params[name].shape)}")
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(params[name].dtype)
    unset = sorted(set(params) - set(out))
    if unset:
        raise KeyError(f"checkpoint misses parameters {unset[:5]} of {type(module).__name__}")
    return out


def read_params_npz(path, module: Optional[torch.nn.Module] = None) -> Dict[str, np.ndarray]:
    """The flat '/'-keyed Flax parameters of a checkpoint, by its suffix as
    the JAX matcher dispatches (recon3d_tpu/neural/matcher.py:107-143): a
    save_params_npz .npz file as stored; any other file is a torch
    checkpoint in the public layout of `module` (a SuperPointNet or a
    LightGlueNet), converted by neural/weights.py."""
    path = Path(path)
    if path.suffix != ".npz":
        if module is None:
            raise ValueError(f"{path.name}: a torch checkpoint is converted for the module "
                             "it fills; pass module=")
        from recon3d_tpu_torch.neural.weights import flax_from_torch

        return flax_from_torch(path, module)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def __getattr__(name: str):
    # load_params_npz lives in neural/weights.py, at the JAX package's
    # path; it is re-exported here on first use because weights.py
    # imports this module.
    if name == "load_params_npz":
        from recon3d_tpu_torch.neural.weights import load_params_npz

        return load_params_npz
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
