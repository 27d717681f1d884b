"""Calibration of the port (recon3d_tpu_torch/calib) against the JAX
package's (recon3d_tpu/calib) on the CPU, on the exactly rendered boards of
tests/test_calibration.py.

The same numpy inputs go through both. The detector is chaotic in the
reference itself: a chessboard's X-corner often has two neighbouring pixels
of nearly equal saddle response, and which one survives the non-max
suppression turns on the last bit of the response; the four refinement
steps from the two starts end up to 0.011 px apart. The JAX reference
moves that far on its own when the image is scaled by 1 +- 2^-22, so
find_chessboard is held to 1.5 times the reference's self-agreement,
computed here per board (1e-3 px at the least), detect_corners to the same
peaks up to such one-pixel moves, and the refinement from one start to
2e-4 px (the reference moves 1.2e-4 px by itself). The solver and the
host functions are held to 1e-5 relative; end to end the port picks the
reference's images and lands within 1e-3 of its K.
"""

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recon3d_tpu.calib import calibrate as jcal
from recon3d_tpu.calib import corners as jcor
from recon3d_tpu.calib import validate as jval
from recon3d_tpu.camera import load_calibration as jax_load_calibration
from recon3d_tpu_torch.calib import calibrate as tcal
from recon3d_tpu_torch.calib import corners as tcor
from recon3d_tpu_torch.calib import validate as tval
from recon3d_tpu_torch.camera import load_calibration
from recon3d_tpu_torch.runtime.profiling import StageTimer
from tests.render import render_chessboard
from tests.test_calibration import DIST_GT, K_GT, PATTERN, _gt_corners, _poses

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
# The refinement from one start: the reference moves 1.2e-4 px by itself
# under a 2^-22 scaling of the image (float32 coordinates near 256 px).
REFINE_ATOL = 2e-4
SOLVER_RTOL = 1e-5
_SCALES = (1 + 2 ** -22, 1 - 2 ** -22)

_jdetect = jax.jit(jcor.detect_corners, static_argnames=("max_corners",))
_jrefine = jax.jit(jcor.refine_corners_gradient)
_jresiduals = jax.jit(jcal._residuals)
_jproject = jax.jit(jcal._project)


@pytest.fixture(scope="module")
def boards():
    poses = _poses(12)
    images = [render_chessboard(K_GT, DIST_GT, r, t, image_size=(240, 320), pattern=PATTERN)
              for r, t in poses]
    return images, poses


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_saddle_response_matches_jax(boards):
    """To 5e-6 of the largest response: the blurred image's rounding
    (~1e-7; the two blurs sum their taps in another order) through the
    second differences and their products (|g''| up to ~0.08)."""
    images, _ = boards
    for img in images[:3]:
        ref = np.asarray(jcor.saddle_response(jnp.asarray(img)))
        got = tcor.saddle_response(_t(img)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-6 * np.abs(ref).max())


def test_detect_corners_matches_jax_on_random_images():
    """On a blurred random image the peaks are well apart in value and
    place: the same candidates in the same order, within 1e-4 px."""
    rng = np.random.default_rng(0)
    for _ in range(3):
        img = np.float32(rng.random((96, 128)))
        ref = _jdetect(jnp.asarray(img), max_corners=64)
        got = tcor.detect_corners(_t(img), max_corners=64)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
        v = np.asarray(ref.valid)
        assert v.sum() >= 8
        np.testing.assert_allclose(got.xy.numpy()[v], np.asarray(ref.xy)[v], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.response.numpy()[v], np.asarray(ref.response)[v],
                                   rtol=1e-5)


def _matched(b, a):
    """Share of the points b within 1e-4 px of one of the points a."""
    return (np.linalg.norm(b[:, None] - a[None], axis=-1).min(1) <= 1e-4).mean()


def test_detect_corners_matches_jax_on_boards(boards):
    """Where two neighbouring pixels tie to the last bits, the one that
    survives the suppression decides the peak, in the reference too: on
    these boards it keeps as few as 76% of its own valid peaks when the
    image is scaled by 1 +- 2^-22 or 1 +- 2^-21. The port's valid peaks: as
    many within two, each at one of the reference's candidates (within
    1e-4 px) or one pixel from it, and the share at its valid peaks no
    more than 0.05 below the reference's lowest self-agreement on the same
    board."""
    images, _ = boards
    for img in images:
        ref = _jdetect(jnp.asarray(img), max_corners=128)
        got = tcor.detect_corners(_t(img), max_corners=128)
        v, vt = np.asarray(ref.valid), got.valid.numpy()
        a, b = np.asarray(ref.xy)[v], got.xy.numpy()[vt]
        assert v.sum() >= 54 and abs(int(vt.sum()) - int(v.sum())) <= 2
        d_all = np.linalg.norm(b[:, None] - np.asarray(ref.xy)[None], axis=-1).min(1)
        assert (d_all <= np.sqrt(2) + 1e-4).all(), d_all.max()
        self_share = []
        for s in (1 + 2 ** -22, 1 - 2 ** -22, 1 + 2 ** -21, 1 - 2 ** -21):
            c = _jdetect(jnp.asarray(np.float32(img * s)), max_corners=128)
            self_share.append(_matched(np.asarray(c.xy)[np.asarray(c.valid)], a))
        assert _matched(b, a) >= min(self_share) - 0.05, (_matched(b, a), self_share)


def test_order_chessboard_corners_is_the_jax_copy(boards):
    images, _ = boards
    for img in images[:6]:
        c = _jdetect(jnp.asarray(img), max_corners=128)
        v = np.asarray(c.valid)
        xy, resp = np.asarray(c.xy)[v], np.asarray(c.response)[v]
        ref = jcor.order_chessboard_corners(xy, PATTERN, response=resp)
        got = tcor.order_chessboard_corners(xy, PATTERN, response=resp)
        assert ref is not None
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(tcor._canonical_order(ref.reshape(6, 9, 2)[::-1]),
                                      jcor._canonical_order(ref.reshape(6, 9, 2)[::-1]))
    assert tcor.order_chessboard_corners(xy[:10], PATTERN) is None


def test_refine_corners_gradient_matches_jax(boards):
    """From the reference's ordered grid, with K1's plain version on the
    CPU: within REFINE_ATOL px."""
    images, _ = boards
    for img in images[:6]:
        c = _jdetect(jnp.asarray(img), max_corners=128)
        v = np.asarray(c.valid)
        grid = jcor.order_chessboard_corners(np.asarray(c.xy)[v], PATTERN,
                                             response=np.asarray(c.response)[v])
        ref = np.asarray(_jrefine(jnp.asarray(img), jnp.asarray(grid)))
        got = tcor.refine_corners_gradient(_t(img), _t(grid)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=REFINE_ATOL)
        assert np.abs(ref - grid).max() > 0.1   # the refinement moves the corners


def _port_grid(img):
    c = tcor.detect_corners(_t(img), max_corners=128)
    v = c.valid.numpy()
    return tcor.order_chessboard_corners(c.xy.numpy()[v], PATTERN, response=c.response.numpy()[v])


def test_find_chessboard_matches_jax(boards):
    """Found on the same boards, within 0.3 px of the true corners at the
    median (tests/test_calibration.py's bound), and each board within
    1e-3 px of the reference. A board further off is held to a tie in the
    detection: each corner whose starting pixel differs from the
    reference's has the reference's saddle response equal at both pixels
    within test_saddle_response_matches_jax's 5e-6 of the largest (the two
    differ by ~1e-9 on these boards, and the refinement's 4 iterations
    leave the two starts ~2e-3 px apart), and the reference's own
    refinement from the port's starting grid lands within REFINE_ATOL of
    the port. None where the reference finds none (a board cut to a
    corner of the image)."""
    images, poses = boards
    errs = []
    for b, (img, (rv, tv)) in enumerate(zip(images, poses)):
        r = jcor.find_chessboard(img, PATTERN)
        got = tcor.find_chessboard(img, PATTERN, device="cpu")
        assert r is not None and got is not None and got.shape == (54, 2)
        assert got.dtype == np.float32
        if np.abs(got - r).max() > 1e-3:
            jd = _jdetect(jnp.asarray(img), max_corners=128)
            v = np.asarray(jd.valid)
            ref_grid = jcor.order_chessboard_corners(np.asarray(jd.xy)[v], PATTERN,
                                                     response=np.asarray(jd.response)[v])
            grid = _port_grid(img)
            resp = np.asarray(jcor.saddle_response(jnp.asarray(img)))
            for k in np.flatnonzero(np.abs(grid - ref_grid).max(1) > 0):
                (x0, y0), (x1, y1) = np.int64(np.round(ref_grid[k])), np.int64(np.round(grid[k]))
                tie = abs(resp[y0, x0] - resp[y1, x1])
                assert tie <= 5e-6 * np.abs(resp).max(), (b, k, tie)
            from_port = np.asarray(_jrefine(jnp.asarray(img), jnp.asarray(grid)))
            np.testing.assert_allclose(got, from_port, rtol=0, atol=REFINE_ATOL)
        errs.append(np.median(np.linalg.norm(got - _gt_corners(rv, tv), axis=1)))
    assert np.median(errs) < 0.3
    blank = np.full((240, 320), 0.5, np.float32)
    blank[:40, :40] = images[0][100:140, 100:140]
    assert jcor.find_chessboard(blank, PATTERN) is None
    assert tcor.find_chessboard(blank, PATTERN, device="cpu") is None


@pytest.fixture(scope="module")
def gt_corners():
    poses = _poses(10)
    return np.stack([_gt_corners(r, t) for r, t in poses]), jcal.board_points(PATTERN)


def test_host_init_functions_match_jax(gt_corners):
    corners, X = gt_corners
    np.testing.assert_array_equal(tcal.board_points(PATTERN, 0.5), jcal.board_points(PATTERN, 0.5))
    Hs = []
    for v in range(len(corners)):
        H = tcal.homography_dlt(X[:, :2], corners[v])
        np.testing.assert_array_equal(H, jcal.homography_dlt(X[:, :2], corners[v]))
        Hs.append(H)
    K = tcal.intrinsics_from_homographies(Hs)
    np.testing.assert_array_equal(K, jcal.intrinsics_from_homographies(Hs))
    for H in Hs:
        r, t = tcal.pose_from_homography(K, H)
        rj, tj = jcal.pose_from_homography(K, H)
        np.testing.assert_allclose(r, rj, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(t, tj)


def _theta(corners, X):
    Hs = [jcal.homography_dlt(X[:, :2], c) for c in corners]
    K = jcal.intrinsics_from_homographies(Hs)
    poses = [jcal.pose_from_homography(K, H) for H in Hs]
    return np.concatenate(
        [np.float32([K[0, 0], K[1, 1], K[0, 2], K[1, 2], -0.05, 0.01, 1e-3, -1e-3])]
        + [np.concatenate([r, t]) for r, t in poses]).astype(np.float32)


def test_project_and_residuals_match_jax(gt_corners):
    corners, X = gt_corners
    theta = _theta(corners, X)
    cam = theta[:8]
    for v in range(3):
        pose = theta[8 + 6 * v: 14 + 6 * v]
        ref = np.asarray(_jproject(jnp.asarray(cam), jnp.asarray(pose[:3]),
                                   jnp.asarray(pose[3:]), jnp.asarray(X)))
        got = tcal._project(_t(cam), _t(pose[:3]), _t(pose[3:]), _t(X)).numpy()
        np.testing.assert_allclose(got, ref, rtol=SOLVER_RTOL)
    # the residuals subtract pixels of ~300 from projections of ~300: held
    # as the projections they are differences of, to 1e-5 relative
    ref = np.asarray(_jresiduals(jnp.asarray(theta), jnp.asarray(X), jnp.asarray(corners)))
    got = tcal._residuals(_t(theta), _t(X), _t(corners)).numpy()
    assert got.shape == ref.shape == (corners.size,)
    flat = corners.reshape(-1)
    np.testing.assert_allclose(got + flat, ref + flat, rtol=SOLVER_RTOL)


def test_lm_step_matches_jax(gt_corners):
    """One step from the same theta and damping: theta within 1e-5 of the
    largest entry of its kind (the camera's, the poses'), the damping
    equal (both take or both refuse the step). The cost after the step is
    the float32 sum of squares of residuals that subtract pixels of ~300
    and of a step solved in float32 from normal equations whose scales span
    1e-3 to 300: the reference's own lies 1.0e-4 from the float64 step's
    (the port in float64, computed here), so each is held to 2e-4 of it."""
    corners, X = gt_corners
    theta = _theta(corners, X)
    for damping in (1e-3, 10.0):
        ref = [np.asarray(o) for o in jcal._lm_step(
            jnp.asarray(theta), jnp.asarray(X), jnp.asarray(corners), jnp.float32(damping))]
        got = [o.numpy() for o in tcal._lm_step(
            _t(theta), _t(X), _t(corners), torch.tensor(damping, dtype=torch.float32))]
        f64 = [o.numpy() for o in tcal._lm_step(
            _t(theta).double(), _t(X).double(), _t(corners).double(),
            torch.tensor(damping, dtype=torch.float64))]
        assert not np.array_equal(ref[0], theta)   # the step was taken
        for a, b in ((got[0][:8], ref[0][:8]), (got[0][8:], ref[0][8:])):
            np.testing.assert_allclose(a, b, rtol=0, atol=SOLVER_RTOL * np.abs(b).max())
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_allclose(ref[2], f64[2], rtol=2e-4)
        np.testing.assert_allclose(got[2], f64[2], rtol=2e-4)


def test_calibrate_from_gt_corners(gt_corners):
    """tests/test_calibration.py::test_calibrate_from_gt_corners's bounds
    on the port, and the port within 1e-3 of the reference's K and 1e-3 px
    of its per-image RMS."""
    corners, X = gt_corners
    K, dist, rvecs, tvecs, rms = tcal.calibrate_from_corners(corners, X, device="cpu")
    assert rms.max() < 0.05, f"rms {rms.max():.4f}"
    assert abs(K[0, 0] - K_GT[0, 0]) / K_GT[0, 0] < 0.005
    assert abs(K[1, 1] - K_GT[1, 1]) / K_GT[1, 1] < 0.005
    assert abs(K[0, 2] - K_GT[0, 2]) < 1.5
    assert abs(K[1, 2] - K_GT[1, 2]) < 1.5
    np.testing.assert_allclose(dist[:2], DIST_GT[:2], atol=0.01)
    Kj, distj, rj, tj, rmsj = jcal.calibrate_from_corners(corners, X)
    np.testing.assert_allclose(K, Kj, rtol=1e-3)
    np.testing.assert_allclose(rms, rmsj, rtol=0, atol=1e-3)
    np.testing.assert_allclose(dist, distj, rtol=0, atol=1e-3)
    assert rvecs.shape == tvecs.shape == (len(corners), 3)


def test_calibrate_camera_robust_end_to_end(boards, tmp_path):
    """tests/test_calibration.py::test_calibrate_camera_robust_end_to_end on
    the port, against the reference: the same images used, K within 1e-3
    relative, the .npz read by both packages' load_calibration, the
    validator within 1e-3 px of the reference's on the same calibration."""
    images, _ = boards
    ref = jcal.calibrate_camera_robust(images, PATTERN, error_threshold=0.5, min_images=6,
                                       verbose=False)
    timer = StageTimer()
    res = tcal.calibrate_camera_robust(images, PATTERN, error_threshold=0.5, min_images=6,
                                       output_dir=str(tmp_path), verbose=False, device="cpu",
                                       timer=timer)
    assert res is not None and res["used_indices"] == ref["used_indices"]
    names = [name for name, _ in timer.stages]
    assert names.count("detect") == len(images) and names.count("refine") == len(images)
    assert names.count("lm") == 1 + len(images) - len(res["used_indices"])
    K = res["K"]
    assert abs(K[0, 0] - K_GT[0, 0]) / K_GT[0, 0] < 0.02, K
    assert abs(K[1, 1] - K_GT[1, 1]) / K_GT[1, 1] < 0.02, K
    assert res["overall_rms"] < 0.5
    np.testing.assert_allclose(K, ref["K"], rtol=1e-3)
    assert abs(res["overall_rms"] - ref["overall_rms"]) < 1e-3

    npz = str(tmp_path / "calibration_data.npz")
    np.testing.assert_allclose(np.asarray(load_calibration(npz).K), K, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jax_load_calibration(npz).K), K, rtol=1e-6)
    assert (tmp_path / "calibration_data.txt").read_text().startswith("Camera Calibration")

    used = [images[i] for i in res["used_indices"]]
    args = (K, res["dist"], res["rvecs"], res["tvecs"], PATTERN)
    errors = tval.validate_calibration(used, *args, verbose=False, device="cpu")
    ref_errors = jval.validate_calibration(used, *args, verbose=False)
    valid = errors[~np.isnan(errors)]
    assert len(valid) >= 4 and np.median(valid) < 1.0
    np.testing.assert_allclose(errors, ref_errors, rtol=0, atol=1e-3)


def test_find_chessboard_timer_records_its_steps(boards):
    """find_chessboard's timer gets one "detect", "order" and "refine" for a
    found board, and stops where a board is not found; the corners are the
    same with or without it."""
    images, _ = boards
    timer = StageTimer()
    got = tcor.find_chessboard(images[0], PATTERN, device="cpu", timer=timer)
    assert [name for name, _ in timer.stages] == ["detect", "order", "refine"]
    assert all(dt >= 0.0 for _, dt in timer.stages)
    np.testing.assert_array_equal(got, tcor.find_chessboard(images[0], PATTERN, device="cpu"))
    timer = StageTimer()
    assert tcor.find_chessboard(np.full((240, 320), 0.5, np.float32), PATTERN, device="cpu",
                                timer=timer) is None
    assert [name for name, _ in timer.stages] == ["detect"]


def test_module_cli_on_pngs(boards, tmp_path):
    """python -m recon3d_tpu_torch.calib.calibrate DIR -o OUT --device cpu
    on 8-bit PNGs of the boards, then the validator's CLI on its .npz
    against the reference's."""
    from PIL import Image

    images, _ = boards
    img_dir = tmp_path / "boards"
    img_dir.mkdir()
    for i, img in enumerate(images):
        Image.fromarray(np.uint8(np.round(img * 255))).save(img_dir / f"board_{i:02d}.png")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # as many threads as the tests' own (torch.set_num_threads(2) above): a
    # child with one thread per core next to the other test workers runs
    # ~10x slower
    env["OMP_NUM_THREADS"] = "2"
    out = tmp_path / "calib"
    r = subprocess.run([sys.executable, "-m", "recon3d_tpu_torch.calib.calibrate", str(img_dir),
                        "-o", str(out), "--device", "cpu"],
                       cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    data = np.load(out / "calibration_data.npz")
    assert abs(data["mtx"][0, 0] - K_GT[0, 0]) / K_GT[0, 0] < 0.02
    assert data["dist"].shape == (1, 5)
    # the validator's CLI pairs image i with stored pose i, as the
    # reference's does (here, where the calibration dropped boards, both
    # fail); which borderline 8-bit boards are found is the detector's
    # chaos (above), so the tables are not compared line by line
    argv = [str(img_dir), str(out / "calibration_data.npz")]
    with contextlib.redirect_stdout(io.StringIO()) as ref_out:
        ref_rc = jval.main(argv)
    with contextlib.redirect_stdout(io.StringIO()) as got_out:
        got_rc = tval.main(argv + ["--device", "cpu"])
    assert got_rc == ref_rc
    assert "Per-image reprojection error:" in got_out.getvalue().splitlines()
    assert "Per-image reprojection error:" in ref_out.getvalue().splitlines()


def test_default_device_refuses_without_a_gpu(boards):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    images, _ = boards
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcor.find_chessboard(images[0], PATTERN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcal.calibrate_camera_robust(images, PATTERN, verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcal.calibrate_from_corners(np.zeros((3, 54, 2), np.float32), tcal.board_points())


def test_torch_chessboard_matches_render_chessboard(boards):
    """tests/torch_chessboard.py (the port's ops, no JAX) renders the
    boards of tests/render.py::render_chessboard within 1e-5 a pixel."""
    from tests.torch_chessboard import render_chessboard as torch_render

    images, poses = boards
    for img, (r, t) in zip(images[:4], poses[:4]):
        got = torch_render(K_GT, DIST_GT, r, t, image_size=(240, 320), pattern=PATTERN)
        assert got.shape == img.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, img, rtol=0, atol=1e-5)
