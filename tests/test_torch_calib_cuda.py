"""Calibration on the card against the same code on the CPU.

Corner refinement samples the two gradient planes at every corner's
window through K1 on the card (one launch an iteration, 4 a board) and
through its plain version on the CPU. Every test here is marked `cuda`
and skips without a GPU. The file imports neither jax nor the JAX package,
so it also runs on a GPU machine without them:

    python -m pytest --noconftest tests/test_torch_calib_cuda.py
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

# An installed package named `tests` would win over this directory, which
# has no __init__.py: bind the name to it, as chip_smoke.py does, unless it
# is bound already.
_HERE = str(Path(__file__).resolve().parent)
if _HERE not in [str(Path(p).resolve()) for p in getattr(sys.modules.get("tests"), "__path__", [])]:
    sys.modules["tests"] = types.ModuleType("tests")
    sys.modules["tests"].__path__ = [_HERE]

from recon3d_tpu_torch.calib import calibrate as tcal  # noqa: E402
from recon3d_tpu_torch.calib import corners as tcor  # noqa: E402
from recon3d_tpu_torch.kernels import warp  # noqa: E402
from recon3d_tpu_torch.ops.image import central_gradients, gaussian_blur  # noqa: E402
from tests.torch_chessboard import board_poses, render_chessboard  # noqa: E402

pytestmark = pytest.mark.cuda

PATTERN = (9, 6)
K = np.array([[300.0, 0, 160.0], [0, 298.0, 120.0], [0, 0, 1]], np.float32)
DIST = np.array([-0.12, 0.05, 0.001, -0.0015, 0.0], np.float32)
SIZE = (240, 320)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (compares the card with the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def boards():
    poses, corners = board_poses(12, K, DIST, SIZE, PATTERN)
    return [render_chessboard(K, DIST, r, t, SIZE, PATTERN) for r, t in poses], corners


def test_k1_at_the_refinement_shape_is_bit_identical(cuda_device, boards):
    """The two gradient planes of a board sampled at 54 windows of 11x11
    points: K1 against its plain version on the card, bit for bit."""
    images, corners = boards
    g = gaussian_blur(torch.from_numpy(images[0]).to(cuda_device), 1.0)
    planes = torch.stack(central_gradients(g)).contiguous()
    ar = torch.arange(-5, 6, dtype=torch.float32, device=cuda_device)
    oy, ox = torch.meshgrid(ar, ar, indexing="ij")
    offsets = torch.stack([ox, oy], -1).reshape(-1, 2)
    q = torch.from_numpy(corners[0]).to(cuda_device)
    coords = (q[:, None] + offsets).reshape(1, -1, 2).contiguous()
    warp.counts.reset()
    out, valid = warp.tent_warp(planes, coords)
    ref, ref_valid = warp.tent_warp_reference(planes, coords)
    torch.cuda.synchronize()
    assert warp.counts.kernel == 1 and dict(warp.counts.by_shape) == {"2x240x320/1x6534": 1}
    assert torch.equal(valid, ref_valid) and torch.equal(out, ref)


def test_find_chessboard_on_the_card_matches_the_cpu(cuda_device, boards):
    """Every board found on both; 4 K1 launches a board at the refinement
    shape and no plain call; within 1e-3 px of the CPU, or within 1.5 times
    the CPU's own spread under a 2^-22 scaling of the image where a
    near-tie of two peak pixels flips (tests/test_torch_calib.py); the
    median over boards of each board's median distance to the true corners
    under 0.3 px (tests/test_calibration.py's bound)."""
    images, corners = boards
    truth = []
    for img, gt in zip(images, corners):
        cpu = tcor.find_chessboard(img, PATTERN, device="cpu")
        warp.counts.reset()
        card = tcor.find_chessboard(img, PATTERN, device="cuda")
        torch.cuda.synchronize()
        assert warp.counts.kernel == 4 and warp.counts.plain == 0
        assert cpu is not None and card is not None
        err = np.abs(card - cpu).max()
        if err > 1e-3:
            spread = max(np.abs(tcor.find_chessboard(np.float32(img * s), PATTERN,
                                                     device="cpu") - cpu).max()
                         for s in (1 + 2 ** -22, 1 - 2 ** -22))
            assert err <= 1.5 * spread, (err, spread)
        truth.append(np.median(np.linalg.norm(card - gt, axis=1)))
    assert np.median(truth) < 0.3


def test_refinement_on_the_card_matches_the_cpu(cuda_device, boards):
    """From the same start (the true corners moved by up to 0.7 px):
    within 2e-4 px of the CPU."""
    images, corners = boards
    rng = np.random.default_rng(0)
    for img, gt in zip(images[:4], corners[:4]):
        start = np.float32(gt + rng.uniform(-0.5, 0.5, gt.shape))
        cpu = tcor.refine_corners_gradient(torch.from_numpy(img), torch.from_numpy(start))
        card = tcor.refine_corners_gradient(torch.from_numpy(img).to(cuda_device),
                                            torch.from_numpy(start).to(cuda_device))
        np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=0, atol=2e-4)


def test_calibration_on_the_card_matches_the_cpu(cuda_device, boards):
    """calibrate_camera_robust end to end: the same images used, K within
    1e-4 relative, the RMS within 1e-3 px, and the true camera within
    tests/test_calibration.py's bounds."""
    images, _ = boards
    cpu = tcal.calibrate_camera_robust(images, PATTERN, min_images=6, verbose=False,
                                       device="cpu")
    card = tcal.calibrate_camera_robust(images, PATTERN, min_images=6, verbose=False,
                                        device="cuda")
    assert card["used_indices"] == cpu["used_indices"]
    np.testing.assert_allclose(card["K"], cpu["K"], rtol=1e-4)
    assert abs(card["overall_rms"] - cpu["overall_rms"]) < 1e-3
    assert abs(card["K"][0, 0] - K[0, 0]) / K[0, 0] < 0.02
    assert card["overall_rms"] < 0.5
