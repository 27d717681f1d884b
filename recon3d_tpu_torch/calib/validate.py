"""Calibration validation: per-image reprojection-error report (PyTorch
port of recon3d_tpu/calib/validate.py).

Re-detect chessboard corners in each image, project the board through the
stored calibration, and print a per-image error table graded
OK(<0.5px) / WARN(<1.0px) / BAD, plus the worst offenders.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.calib.calibrate import _project, board_points
from recon3d_tpu_torch.calib.corners import find_chessboard
from recon3d_tpu_torch.runtime.device import resolve_device

GRADE_EXCELLENT_PX = 0.5
GRADE_ACCEPTABLE_PX = 1.0


def validate_calibration(
    images: Sequence[np.ndarray],
    K: np.ndarray,
    dist: np.ndarray,
    rvecs: np.ndarray,
    tvecs: np.ndarray,
    pattern: Tuple[int, int] = (9, 6),
    square_size: float = 1.0,
    verbose: bool = True,
    device="cuda",
):
    """Returns per-image RMS errors (NaN where detection failed or no stored
    pose) and prints the grade table."""
    dev = resolve_device(device)
    X = torch.from_numpy(board_points(pattern, square_size)).to(dev)
    cam = torch.tensor(
        [K[0, 0], K[1, 1], K[0, 2], K[1, 2], dist[0], dist[1], dist[2], dist[3]],
        dtype=torch.float32, device=dev,
    )
    n_poses = len(rvecs)
    errors = np.full(len(images), np.nan)
    for i, img in enumerate(images):
        if i >= n_poses:
            break
        corners = find_chessboard(img, pattern, device=dev)
        if corners is None:
            if verbose:
                print(f"  image {i:3d}: corners not found")
            continue
        rvec = torch.as_tensor(np.asarray(rvecs[i], np.float32), device=dev)
        tvec = torch.as_tensor(np.asarray(tvecs[i], np.float32), device=dev)
        proj = _project(cam, rvec, tvec, X).cpu().numpy()
        errors[i] = float(np.sqrt(((proj - corners) ** 2).sum(-1).mean()))

    if verbose:
        print("Per-image reprojection error:")
        for i, e in enumerate(errors):
            if np.isnan(e):
                continue
            grade = (
                "OK" if e < GRADE_EXCELLENT_PX
                else "WARN" if e < GRADE_ACCEPTABLE_PX
                else "BAD"
            )
            print(f"  image {i:3d}: {e:7.3f} px  [{grade}]")
        valid = errors[~np.isnan(errors)]
        if len(valid):
            print(f"  mean {valid.mean():.3f} px, max {valid.max():.3f} px")
            worst = np.argsort(-np.nan_to_num(errors, nan=-1))[:5]
            print("  worst:", [int(w) for w in worst if not np.isnan(errors[w])])
    return errors


def main(argv=None):
    """Module CLI:
    python -m recon3d_tpu_torch.calib.validate <image_dir> <calibration.npz>
        [--pattern 9x6] [--device cpu]"""
    import argparse

    from recon3d_tpu_torch.calib.calibrate import _load_gray_images

    p = argparse.ArgumentParser(description="Validate a calibration")
    p.add_argument("image_dir")
    p.add_argument("calibration")
    p.add_argument("--pattern", default="9x6")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where detection runs (default cuda)")
    args = p.parse_args(argv)
    cols, rows = (int(v) for v in args.pattern.split("x"))
    data = np.load(args.calibration)
    images = _load_gray_images(args.image_dir)
    errors = validate_calibration(
        images, data["mtx"], np.ravel(data["dist"]),
        data["rvecs"], data["tvecs"], (cols, rows), device=args.device,
    )
    valid = errors[~np.isnan(errors)]
    return 0 if len(valid) and valid.max() < GRADE_ACCEPTABLE_PX else 1


if __name__ == "__main__":
    raise SystemExit(main())
