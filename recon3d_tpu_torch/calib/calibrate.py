"""Camera calibration: Zhang initialization + Levenberg-Marquardt
(PyTorch port of recon3d_tpu/calib/calibrate.py).

Detect chessboard corners per image, estimate intrinsics [fx, fy, cx, cy]
+ distortion [k1, k2, p1, p2] (k3 fixed at 0, OpenCV's CALIB_FIX_K3),
iteratively drop the worst image until max per-image reprojection error is
below threshold or too few images remain, save .npz (mtx, dist, rvecs,
tvecs) + a text report.

The residual is the full projection model (so3_exp poses -> distortion ->
pinhole), the Jacobian comes from torch.func.jacfwd, and the LM
normal-equation solve is a dense float32 solve (8 + 6V parameters). The
damping update and the accept/reject are torch.where on device tensors, so
the LM loop makes no host sync until it ends.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.calib.corners import find_chessboard
from recon3d_tpu_torch.ops.image import distort_points
from recon3d_tpu_torch.ops.lie import so3_exp, so3_log
from recon3d_tpu_torch.runtime.device import resolve_device
from recon3d_tpu_torch.runtime.profiling import StageTimer


def board_points(pattern: Tuple[int, int] = (9, 6), square_size: float = 1.0):
    """(cols*rows, 3) board-frame corner coordinates, z = 0, row-major."""
    cols, rows = pattern
    jj, ii = np.meshgrid(np.arange(cols), np.arange(rows))
    X = np.stack(
        [jj.ravel() * square_size, ii.ravel() * square_size, np.zeros(cols * rows)],
        axis=-1,
    )
    return X.astype(np.float32)


def homography_dlt(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Normalized DLT homography src (N,2) -> dst (N,2). Host-side (init only)."""
    def norm(p):
        c = p.mean(0)
        s = np.sqrt(2) / (np.linalg.norm(p - c, axis=1).mean() + 1e-12)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
        ph = np.concatenate([p, np.ones((len(p), 1))], axis=1) @ T.T
        return ph, T

    sh, Ts = norm(src)
    dh, Td = norm(dst)
    A = []
    for (x, y, _), (u, v, _) in zip(sh, dh):
        A.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        A.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    A = np.asarray(A)
    _, _, Vt = np.linalg.svd(A)
    H = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ H @ Ts
    return H / H[2, 2]


def intrinsics_from_homographies(Hs: Sequence[np.ndarray]) -> np.ndarray:
    """Zhang's closed-form intrinsics from >= 3 board homographies
    (zero-skew enforced afterwards)."""
    def v(H, i, j):
        return np.array(
            [
                H[0, i] * H[0, j],
                H[0, i] * H[1, j] + H[1, i] * H[0, j],
                H[1, i] * H[1, j],
                H[2, i] * H[0, j] + H[0, i] * H[2, j],
                H[2, i] * H[1, j] + H[1, i] * H[2, j],
                H[2, i] * H[2, j],
            ]
        )

    V = []
    for H in Hs:
        V.append(v(H, 0, 1))
        V.append(v(H, 0, 0) - v(H, 1, 1))
    V = np.asarray(V)
    _, _, Vt = np.linalg.svd(V)
    b = Vt[-1]
    B = np.array(
        [[b[0], b[1], b[3]], [b[1], b[2], b[4]], [b[3], b[4], b[5]]]
    )
    if B[0, 0] < 0:
        B = -B
    cy = (B[0, 1] * B[0, 2] - B[0, 0] * B[1, 2]) / (
        B[0, 0] * B[1, 1] - B[0, 1] ** 2
    )
    lam = B[2, 2] - (B[0, 2] ** 2 + cy * (B[0, 1] * B[0, 2] - B[0, 0] * B[1, 2])) / B[0, 0]
    fx = np.sqrt(max(lam / B[0, 0], 1e-6))
    fy = np.sqrt(max(lam * B[0, 0] / (B[0, 0] * B[1, 1] - B[0, 1] ** 2), 1e-6))
    cx = -B[0, 2] * fx * fx / lam
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def pose_from_homography(K: np.ndarray, H: np.ndarray):
    """Initial (rvec, tvec) of a planar board from its homography."""
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = (Kinv @ H).T[:3]
    s = 1.0 / (np.linalg.norm(h1) + 1e-12)
    r1, r2 = h1 * s, h2 * s
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1, 1, -1]) @ Vt
    t = h3 * s
    if t[2] < 0:
        R = np.stack([-r1, -r2, np.cross(-r1, -r2)], axis=1)
        U, _, Vt = np.linalg.svd(R)
        R = U @ Vt
        t = -t
    rvec = so3_log(torch.from_numpy(R.astype(np.float32))).numpy()
    return rvec.astype(np.float32), t.astype(np.float32)


def _project(params_cam, rvec, tvec, X):
    """Full projection model. params_cam = [fx, fy, cx, cy, k1, k2, p1, p2];
    rvec and tvec (..., 3) give (..., N, 2) for X (N, 3)."""
    fx, fy, cx, cy = params_cam[0], params_cam[1], params_cam[2], params_cam[3]
    dist = torch.cat([params_cam[4:8], params_cam.new_zeros(1)])
    R = so3_exp(rvec)
    Xc = torch.einsum("...ij,nj->...ni", R, X) + tvec[..., None, :]
    z = torch.where(Xc[..., 2:3].abs() < 1e-8, 1e-8, Xc[..., 2:3])
    xy = Xc[..., :2] / z
    xyd = distort_points(xy, dist)
    return torch.stack([fx * xyd[..., 0] + cx, fy * xyd[..., 1] + cy], dim=-1)


def _residuals(theta, X, corners):
    """theta = [8 camera params | V * (rvec, tvec)]; corners (V, N, 2)."""
    V = corners.shape[0]
    cam = theta[:8]
    pose = theta[8:].reshape(V, 6)
    proj = _project(cam, pose[:, :3], pose[:, 3:], X)
    return (proj - corners).reshape(-1)


def _lm_step(theta, X, corners, damping):
    """One damped Gauss-Newton step, kept when it lowers the cost. Returns
    (theta, damping, cost), all device tensors."""
    r = _residuals(theta, X, corners)
    J = torch.func.jacfwd(_residuals)(theta, X, corners)
    JtJ = J.T @ J
    g = J.T @ r
    A = JtJ + damping * torch.diag(torch.clamp(torch.diagonal(JtJ), min=1e-8))
    # solve_ex: no check of the factorization's info, hence no host sync; a
    # singular A gives non-finite steps, which the cost test rejects
    step = torch.linalg.solve_ex(A, g)[0]
    theta_new = theta - step
    r_new = _residuals(theta_new, X, corners)
    cost, cost_new = torch.sum(r * r), torch.sum(r_new * r_new)
    better = cost_new < cost
    theta = torch.where(better, theta_new, theta)
    damping = torch.where(better, damping * 0.5, damping * 4.0)
    return theta, damping, torch.where(better, cost_new, cost)


def calibrate_from_corners(
    corners: np.ndarray,              # (V, N, 2)
    X: np.ndarray,                    # (N, 3) board points, z = 0
    iterations: int = 60,
    device="cuda",
):
    """Zhang init (host) + LM refine (on `device`). Returns (K (3,3), dist
    (5,), rvecs (V,3), tvecs (V,3), per_image_rms (V,))."""
    dev = resolve_device(device)
    V = corners.shape[0]
    Hs = [homography_dlt(X[:, :2], corners[v]) for v in range(V)]
    K = intrinsics_from_homographies(Hs)
    poses = [pose_from_homography(K, H) for H in Hs]

    theta = np.concatenate(
        [
            np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0, 0, 0, 0], np.float32),
        ]
        + [np.concatenate([r, t]) for r, t in poses]
    ).astype(np.float32)

    theta_t = torch.from_numpy(theta).to(dev)
    Xt = torch.as_tensor(X, dtype=torch.float32, device=dev)
    ct = torch.as_tensor(corners, dtype=torch.float32, device=dev)
    damping = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    for _ in range(iterations):
        theta_t, damping, _ = _lm_step(theta_t, Xt, ct, damping)

    theta = theta_t.cpu().numpy()
    cam = theta[:8]
    K = np.array(
        [[cam[0], 0, cam[2]], [0, cam[1], cam[3]], [0, 0, 1]], np.float32
    )
    dist = np.concatenate([cam[4:8], [0.0]]).astype(np.float32)
    pose = theta[8:].reshape(V, 6)
    res = _residuals(theta_t, Xt, ct).cpu().numpy().reshape(V, -1, 2)
    rms = np.sqrt((res ** 2).sum(-1).mean(-1))
    return K, dist, pose[:, :3].copy(), pose[:, 3:].copy(), rms


def calibrate_camera_robust(
    images: Sequence[np.ndarray],
    pattern: Tuple[int, int] = (9, 6),
    square_size: float = 1.0,
    error_threshold: float = 0.5,
    min_images: int = 10,
    output_dir: Optional[str] = None,
    verbose: bool = True,
    device="cuda",
    timer: Optional[StageTimer] = None,
):
    """Full robust calibration: detect corners in every image, calibrate,
    iteratively drop the worst image while max per-image RMS >
    error_threshold and > min_images remain.

    images: grayscale float32 [0,1] arrays. timer: a StageTimer that gets
    find_chessboard's steps ("detect", "order", "refine") and each LM solve
    ("lm"). Returns dict with K, dist, rvecs, tvecs, per_image_rms,
    used_indices, or None if detection fails.
    """
    dev = resolve_device(device)
    timer = timer or StageTimer()
    t0 = time.time()
    X = board_points(pattern, square_size)
    detected, idxs = [], []
    for i, img in enumerate(images):
        c = find_chessboard(img, pattern, device=dev, timer=timer)
        if c is not None:
            detected.append(c)
            idxs.append(i)
        elif verbose:
            print(f"[calib] image {i}: chessboard not found")
    if len(detected) < 3:
        print(f"[calib] only {len(detected)} detections — need >= 3")
        return None

    corners = np.stack(detected)
    used = list(range(len(detected)))
    while True:
        with timer.stage("lm"):
            K, dist, rvecs, tvecs, rms = calibrate_from_corners(corners[used], X, device=dev)
        worst = int(np.argmax(rms))
        if verbose:
            print(
                f"[calib] {len(used)} images, rms: mean {rms.mean():.3f} px, "
                f"max {rms.max():.3f} px"
            )
        if rms.max() <= error_threshold or len(used) <= min_images:
            break
        if verbose:
            print(f"[calib] dropping worst image (idx {idxs[used[worst]]}, "
                  f"{rms[worst]:.3f} px)")
        used.pop(worst)

    result = dict(
        K=K, dist=dist, rvecs=rvecs, tvecs=tvecs, per_image_rms=rms,
        used_indices=[idxs[u] for u in used],
        overall_rms=float(np.sqrt((rms ** 2).mean())),
    )
    if output_dir:
        save_calibration(output_dir, result)
    if verbose:
        print(f"[calib] done in {time.time() - t0:.1f}s: "
              f"fx={K[0,0]:.1f} fy={K[1,1]:.1f} "
              f"cx={K[0,2]:.1f} cy={K[1,2]:.1f}, rms {result['overall_rms']:.3f} px")
    return result


def save_calibration(output_dir: str, result: dict):
    """Write calibration_data.npz (mtx, dist, rvecs, tvecs — OpenCV's
    layout, loadable by camera.load_calibration of either package) and a
    human-readable calibration_data.txt."""
    os.makedirs(output_dir, exist_ok=True)
    np.savez(
        os.path.join(output_dir, "calibration_data.npz"),
        mtx=result["K"],
        dist=result["dist"].reshape(1, -1),
        rvecs=result["rvecs"],
        tvecs=result["tvecs"],
    )
    K, dist = result["K"], result["dist"]
    lines = [
        "Camera Calibration Results",
        "==========================",
        f"Overall RMS reprojection error: {result['overall_rms']:.4f} px",
        f"Mean per-image RMS: {result['per_image_rms'].mean():.4f} px",
        f"Images used: {len(result['used_indices'])}",
        "",
        "Intrinsic matrix:",
        f"  fx = {K[0,0]:.4f}",
        f"  fy = {K[1,1]:.4f}",
        f"  cx = {K[0,2]:.4f}",
        f"  cy = {K[1,2]:.4f}",
        "",
        f"Distortion [k1 k2 p1 p2 k3]: {np.array2string(dist, precision=5)}",
    ]
    with open(os.path.join(output_dir, "calibration_data.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _load_gray_images(image_dir: str):
    from PIL import Image

    from recon3d_tpu_torch.io.dataset import list_images

    out = []
    for f in list_images(image_dir):
        im = Image.open(os.path.join(image_dir, f)).convert("L")
        out.append(np.asarray(im, np.float32) / 255.0)
    return out


def main(argv=None):
    """Module CLI:
    python -m recon3d_tpu_torch.calib.calibrate <image_dir> [-o out]
        [--pattern 9x6] [--device cpu]"""
    import argparse

    p = argparse.ArgumentParser(description="Chessboard camera calibration")
    p.add_argument("image_dir")
    p.add_argument("-o", "--output", default="calibration_results")
    p.add_argument("--pattern", default="9x6", help="inner corners, e.g. 9x6")
    p.add_argument("--square-size", type=float, default=1.0)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where detection and the solve run (default cuda)")
    args = p.parse_args(argv)
    cols, rows = (int(v) for v in args.pattern.split("x"))
    images = _load_gray_images(args.image_dir)
    result = calibrate_camera_robust(
        images, (cols, rows), args.square_size,
        error_threshold=args.threshold, output_dir=args.output,
        device=args.device,
    )
    return 0 if result else 1


if __name__ == "__main__":
    raise SystemExit(main())
