"""Scene helpers shared by the port's tests, chip_smoke.py and
tests/torch_reference_levels.py. Numpy only: no jax, no torch, so that the
GPU machine, which has no jax, can import it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from tests.render import default_scene_planes


def sparse_from_depth(scene, per_view: int, seed: int = 0,
                      views: Optional[Sequence[int]] = None) -> np.ndarray:
    """World points back-projected from `per_view` random ground-truth depth
    samples of each view (tests/test_patchmatch.py:144-156), standing in for
    SfM's sparse cloud. views: default every view of the scene."""
    rng = np.random.default_rng(seed)
    K = scene["K"]
    pts = []
    for v in range(len(scene["Rs"])) if views is None else views:
        H, W = scene["depth"][v].shape
        ii, jj = rng.integers(0, H, per_view), rng.integers(0, W, per_view)
        d = scene["depth"][v][ii, jj]
        ok = d > 0
        rays = np.stack([(jj[ok] - K[0, 2]) / K[0, 0], (ii[ok] - K[1, 2]) / K[1, 1],
                         np.ones(ok.sum())], -1)
        pts.append((rays * d[ok][:, None] - scene["ts"][v]) @ scene["Rs"][v])
    return np.concatenate(pts).astype(np.float32)


def surface_gate(points: np.ndarray) -> Tuple[float, float]:
    """Median distance of the points to the nearest true scene plane, and
    the share within 0.15: the measures of
    tests/test_patchmatch.py::test_full_mvs_reconstructor."""
    dists = np.full(len(points), np.inf)
    for p in default_scene_planes():
        d_plane = np.abs((points - p.origin) @ p.normal)
        lu = (points - p.origin) @ p.u
        lv = (points - p.origin) @ p.v
        on = (np.abs(lu) <= p.half_u + 0.1) & (np.abs(lv) <= p.half_v + 0.1)
        dists = np.where(on, np.minimum(dists, d_plane), dists)
    return float(np.median(dists)), float((dists < 0.15).mean())


def true_fundamental(K, R1, t1, R2, t2) -> np.ndarray:
    """F with x2h^T F x1h = 0 for pixels of two views of one world point,
    from the views' world-to-camera poses (x_cam = R x_world + t)."""
    K = np.asarray(K, np.float64)
    R = np.asarray(R2, np.float64) @ np.asarray(R1, np.float64).T
    t = np.asarray(t2, np.float64) - R @ np.asarray(t1, np.float64)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Kinv = np.linalg.inv(K)
    return Kinv.T @ tx @ R @ Kinv


def sampson_np(F, x1, x2) -> np.ndarray:
    """Sampson distance (pixels) of (N, 2) correspondences under F."""
    a = np.concatenate([x1, np.ones((len(x1), 1))], axis=1)
    b = np.concatenate([x2, np.ones((len(x2), 1))], axis=1)
    Fx = a @ F.T
    Ftx = b @ F
    num = np.sum(b * Fx, axis=1) ** 2
    den = Fx[:, 0] ** 2 + Fx[:, 1] ** 2 + Ftx[:, 0] ** 2 + Ftx[:, 1] ** 2
    return np.sqrt(num / np.maximum(den, 1e-12))


def match_graph_levels(matches, kp_xy, scene, n_components: int,
                       threshold_px: float = 2.0) -> dict:
    """Where a verified match graph (SfMPipeline.matches and .kp_xy after
    match_image_pairs) stands against the scene's ground truth: the Sampson
    distance of every inlier match of every kept non-aux pair under the
    true F of its two views."""
    n = len(scene["Rs"])
    dists = []
    for (i, j), m in matches.items():
        if m.get("aux"):
            continue
        F = true_fundamental(scene["K"], scene["Rs"][i], scene["ts"][i],
                             scene["Rs"][j], scene["ts"][j])
        dists.append(sampson_np(F, kp_xy[i][m["idx1"]], kp_xy[j][m["idx2"]]))
    d = np.concatenate(dists) if dists else np.zeros(0)
    adjacent = [(i, i + 1) in matches for i in range(n - 1)]
    return {
        "pairs_kept": len(matches),
        "adjacent_kept": int(sum(adjacent)), "adjacent_total": n - 1,
        "inlier_matches": int(len(d)),
        "median_sampson_px": float(np.median(d)) if len(d) else float("nan"),
        "share_under_threshold": float((d < threshold_px).mean()) if len(d) else 0.0,
        "components": int(n_components),
    }


def umeyama(src: np.ndarray, dst: np.ndarray):
    """Least-squares similarity (s, R, t) with dst ~ s R src + t."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var) if var > 0 else 1.0
    return s, R, mu_d - s * R @ mu_s


def pose_errors(poses, scene) -> dict:
    """Errors of estimated poses {view: (R, t)} against the scene's true
    ones over the registered views, after the similarity that aligns the
    estimated camera centres to the true ones (the measure of
    scripts/northstar_run.py pose_errors): centre distances in scene units
    and rotation angles in degrees."""
    ids = sorted(poses)
    Rs_e = np.stack([np.asarray(poses[i][0], np.float64) for i in ids])
    ts_e = np.stack([np.asarray(poses[i][1], np.float64).reshape(3) for i in ids])
    Rs_g = np.asarray(scene["Rs"], np.float64)[ids]
    ts_g = np.asarray(scene["ts"], np.float64)[ids]
    C_e = -np.einsum("vij,vi->vj", Rs_e, ts_e)
    C_g = -np.einsum("vij,vi->vj", Rs_g, ts_g)
    s, R, t = umeyama(C_e, C_g)
    center_err = np.linalg.norm((s * C_e @ R.T + t) - C_g, axis=1)
    rot_errs = []
    for Re, Rg in zip(Rs_e, Rs_g):
        dR = Rg @ (Re @ R.T).T
        rot_errs.append(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))
    return {
        "mean_center_err": float(center_err.mean()),
        "max_center_err": float(center_err.max()),
        "mean_rot_err_deg": float(np.mean(rot_errs)),
        "max_rot_err_deg": float(np.max(rot_errs)),
    }



def to_scene_frame(points: np.ndarray, poses, scene) -> np.ndarray:
    """Points of a reconstruction made with estimated poses {view: (R, t)}
    (an SfM frame: its own scale, rotation and origin) mapped into the
    scene's frame by the similarity X_scene = s A X + b that best carries
    the estimated cameras onto the true ones: A is the rotation nearest to
    the sum of R_true^T R_est over the views (camera centres alone leave
    the rotation about a short arc's chord free), s and b the least-squares
    fit of the centres given A. Then surface_gate can hold them to the true
    planes."""
    ids = sorted(poses)
    Rs_e = np.stack([np.asarray(poses[i][0], np.float64) for i in ids])
    ts_e = np.stack([np.asarray(poses[i][1], np.float64).reshape(3) for i in ids])
    Rs_g = np.asarray(scene["Rs"], np.float64)[ids]
    ts_g = np.asarray(scene["ts"], np.float64)[ids]
    U, _, Vt = np.linalg.svd(np.einsum("vji,vjk->ik", Rs_g, Rs_e))
    A = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    C_e = -np.einsum("vij,vi->vj", Rs_e, ts_e) @ A.T
    C_g = -np.einsum("vij,vi->vj", Rs_g, ts_g)
    de, dg = C_e - C_e.mean(0), C_g - C_g.mean(0)
    s = float((de * dg).sum() / (de * de).sum())
    b = C_g.mean(0) - s * C_e.mean(0)
    return (s * np.asarray(points, np.float64) @ A.T + b).astype(np.float32)
