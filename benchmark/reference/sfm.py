"""Plain reference for the SfM cell: how far the registered cameras and the
sparse points of one scene lie from the rendered truth, in float64 numpy.

The reconstruction's frame is arbitrary up to a similarity, so the
estimated camera centres are aligned to the true ones first (Umeyama's
least-squares similarity, as scripts/northstar_run.py does), and the
cameras and points are judged in the true frame. It imports nothing of the
program.

Numbers of one scene (`check_scene`):
  registered_share  registered cameras / views
  rot_err_max_deg   the largest angle between an aligned rotation and the truth
  point_dist_med    the median distance of the aligned sparse points from the
                    scene's surface, over the arc's radius
  reproj_p90_px     the 90th percentile, over the model's observations (a
                    point, a registered camera, the keypoint it was seen
                    at), of the distance in pixels between the keypoint and
                    the point projected by that camera with the camera K
                    the program was handed: the sparse model as a COLMAP
                    export holds it (`reproj_med_px`, `reproj_mean_px`: the
                    median and the mean)

`control_scene` is the control: this reference's own answer (the true
cameras, surface points and their projections) computed in bfloat16 and
put in the program's place.
"""

from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np
import torch

ARC_RADIUS = 3.5


def umeyama(src: np.ndarray, dst: np.ndarray):
    """(s, R, t) minimising |dst - (s R src + t)|^2 over the rows."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var) if var > 0 else 1.0
    return s, R, mu_d - s * R @ mu_s


def surface_distance(points: np.ndarray, planes: List) -> np.ndarray:
    """Distance of each point to the nearest of the planes' rectangles."""
    best = np.full(len(points), np.inf)
    for p in planes:
        o, u, v = (np.asarray(a, np.float64) for a in (p.origin, p.u, p.v))
        d = points - o
        lu = np.clip(d @ u, -p.half_u, p.half_u)
        lv = np.clip(d @ v, -p.half_v, p.half_v)
        best = np.minimum(best, np.linalg.norm(d - lu[:, None] * u - lv[:, None] * v, axis=1))
    return best


def reprojection_errors(K: np.ndarray, poses: dict, points: np.ndarray,
                        observations: List, kp_xy: List) -> np.ndarray:
    """Pixel distance, in float64, between each observation's keypoint and
    its point projected by its camera; observations[p] lists (camera,
    keypoint) of point p, kp_xy[camera] is (N, 2) x, y."""
    lens = np.fromiter((len(o) for o in observations), np.int64, len(observations))
    pid = np.repeat(np.arange(len(observations)), lens)
    flat = np.fromiter(itertools.chain.from_iterable(itertools.chain.from_iterable(observations)),
                       np.int64, 2 * int(lens.sum())).reshape(-1, 2)
    cam, kp = flat[:, 0], flat[:, 1]
    keep = np.isin(cam, np.fromiter(poses, np.int64, len(poses)))
    errs = []
    for c in np.unique(cam[keep]):
        sel = keep & (cam == c)
        R, t = (np.asarray(a, np.float64) for a in poses[int(c)])
        Xc = np.asarray(points, np.float64)[pid[sel]] @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:3] * np.diag(K)[:2] + K[:2, 2]
        errs.append(np.linalg.norm(uv - np.asarray(kp_xy[int(c)], np.float64)[kp[sel]], axis=1))
    return np.concatenate(errs) if errs else np.zeros(0)


def control_scene(capture: dict, count: int, seed: int, dtype=torch.bfloat16) -> dict:
    """The control: the true cameras, `count` surface points drawn from the
    seed and their projections into every camera that sees them (the
    surface along the pixel's ray lies within 1% of the point's depth),
    computed in `dtype`; the same keys as the program's scene."""
    from benchmark import scene as bench_scene

    spec = capture["spec"]
    P = bench_scene.surface_samples(capture, count, seed).astype(np.float64)
    scale = 1 / 8
    h, w = int(spec["height"] * scale), int(spec["width"] * scale)
    Ks = np.diag([scale, scale, 1.0]) @ capture["K"]
    _, depth = bench_scene.cast(capture["planes"], Ks, capture["Rs"], capture["ts"], h, w,
                                "cpu", shade=False)
    depth = depth.numpy()
    Pl = torch.from_numpy(P).to(dtype)
    K = torch.from_numpy(capture["K"]).to(dtype)
    observations = [[] for _ in range(len(P))]
    kp_xy, poses = [], {}
    for c, (R, t) in enumerate(zip(capture["Rs"], capture["ts"])):
        Xc = P @ R.T + t
        u = Ks[0, 0] * Xc[:, 0] / Xc[:, 2] + Ks[0, 2]
        v = Ks[1, 1] * Xc[:, 1] / Xc[:, 2] + Ks[1, 2]
        xi, yi = np.round(u).astype(np.int64), np.round(v).astype(np.int64)
        inb = (Xc[:, 2] > 0) & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        seen = np.zeros(len(P), bool)
        seen[inb] = np.abs(depth[c, yi[inb], xi[inb]] - Xc[inb, 2]) < 0.01 * Xc[inb, 2]
        Rl, tl = torch.from_numpy(R).to(dtype), torch.from_numpy(t).to(dtype)
        Xl = Pl[torch.from_numpy(seen)] @ Rl.T + tl
        uv = Xl[:, :2] / Xl[:, 2:3] * torch.diagonal(K)[:2] + K[:2, 2]
        kp_xy.append(uv.to(torch.float32).numpy())
        for k, p in enumerate(np.nonzero(seen)[0]):
            observations[p].append((c, k))
        poses[c] = (Rl.to(torch.float32).numpy(), tl.to(torch.float32).numpy())
    return {"poses": poses, "points": Pl.to(torch.float32).numpy(),
            "observations": observations, "kp_xy": kp_xy,
            "features_per_image": [len(k) for k in kp_xy]}


def check_scene(capture: dict, out: dict) -> Dict[str, float]:
    """capture: the rendered scene (true Rs, ts, planes, K); out: the
    program's poses {view: (R, t)}, sparse points (P, 3), their
    observations and the keypoints (`observations`, `kp_xy`) and the
    keypoints found in each image (`features_per_image`). `points` and
    `kp_per_view` are reported beside the numbers, not compared."""
    V = len(capture["Rs"])
    ids = sorted(out["poses"])
    nums = {"registered_share": len(ids) / V, "points": len(out["points"]),
            "kp_per_view": float(np.mean(out["features_per_image"]))}
    err = reprojection_errors(capture["K"], out["poses"], out["points"], out["observations"],
                              out["kp_xy"])
    nums["reproj_med_px"] = float(np.median(err)) if len(err) else np.inf
    nums["reproj_p90_px"] = float(np.percentile(err, 90)) if len(err) else np.inf
    nums["reproj_mean_px"] = float(np.mean(err)) if len(err) else np.inf
    if len(ids) < 3:
        return dict(nums, rot_err_max_deg=180.0, point_dist_med=np.inf)
    R_est = np.stack([np.asarray(out["poses"][i][0], np.float64) for i in ids])
    t_est = np.stack([np.asarray(out["poses"][i][1], np.float64) for i in ids])
    R_true, t_true = capture["Rs"][ids], capture["ts"][ids]
    C_est = -np.einsum("vji,vj->vi", R_est, t_est)
    C_true = -np.einsum("vji,vj->vi", R_true, t_true)
    s, R, t = umeyama(C_est, C_true)
    R_al = R_est @ R.T
    cos = (np.einsum("vij,vij->v", R_al, R_true) - 1.0) / 2.0
    nums["rot_err_max_deg"] = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))).max())
    pts = s * np.asarray(out["points"], np.float64) @ R.T + t
    dist = surface_distance(pts, capture["planes"])
    nums["point_dist_med"] = float(np.median(dist) / ARC_RADIUS) if len(dist) else np.inf
    return nums
