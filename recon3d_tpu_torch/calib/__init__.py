"""Camera calibration: chessboard detection, Zhang + LM solve, validation
(PyTorch port of recon3d_tpu/calib)."""

from recon3d_tpu_torch.calib.calibrate import (
    board_points,
    calibrate_camera_robust,
    calibrate_from_corners,
    save_calibration,
)
from recon3d_tpu_torch.calib.corners import detect_corners, find_chessboard
from recon3d_tpu_torch.calib.validate import validate_calibration

__all__ = [
    "board_points",
    "calibrate_camera_robust",
    "calibrate_from_corners",
    "save_calibration",
    "detect_corners",
    "find_chessboard",
    "validate_calibration",
]
