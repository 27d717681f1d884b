"""tests/test_robustness.py's regimes on the port, on the CPU: occlusion,
exposure / vignetting / noise, a distorted capture, degraded calibration
boards, JPEG and defocus, and the `slow` 300-view global SfM and long-span
accept path. The same scenes (tests/render.py), configurations, seeds and
gates, through SfMPipeline(device="cpu") and
calibrate_camera_robust(device="cpu").

The distorted capture runs twice: as the JAX test runs it (the distorted
arrays handed to the pipeline, which never undistorts them), and through
the undistort-at-load path that the JAX test's docstring names
(tests/torch_robust_check.py: PNGs loaded with the lens, K1's plain version
on the CPU). tests/torch_render.py renders that capture without JAX; it is
held here to tests.render.render_views.
"""

import io

import numpy as np
import pytest
import torch

from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import ReconstructionConfig
from recon3d_tpu_torch.io.dataset import image_set_from_arrays
from recon3d_tpu_torch.sfm.pipeline import SfMPipeline
from tests import torch_render
from tests.render import apply_capture_degradations, occluded_scene_planes, render_views
from tests.synthetic import rotation_angle_deg
from tests.torch_robust_check import (
    DIST,
    GATE,
    SCENE,
    check_gate,
    distorted_capture,
    median_rel_rot_err,
    tuned_config,
    undistort_shape_key,
)

torch.set_num_threads(2)

# tests/torch_render.py against tests/render.py: the two undistort the
# pixel grid in float32 with 20 fixed-point iterations, torch's and XLA's
# roundings apart; the shading moves with the rays by ~1e-6 (1.6e-6 on
# this scene).
RENDER_ATOL = 1e-5


def _run_pipeline(scene, images=None, dist=None):
    cam = Camera.from_matrix(scene["K"], dist)
    iset = image_set_from_arrays(scene["images"] if images is None else images, cam)
    pipe = SfMPipeline(config=tuned_config(), device="cpu")
    points, colors, poses = pipe.reconstruct(image_set=iset)
    return pipe, points, poses


def _check(pipe, poses, scene, n, max_reproj, max_rot):
    assert len(poses) >= n - 1, f"registered {len(poses)}/{n}"
    assert pipe.stats["mean_reproj_px"] < max_reproj
    assert median_rel_rot_err(pipe.poses, scene["Rs"]) < max_rot


def test_occlusion_heavy_sfm():
    """Floating panels occlude a different slice of the background from
    every view; all cameras must still register accurately."""
    n = 8
    scene = render_views(n_views=n, image_size=(160, 192), arc_step=0.12,
                         planes=occluded_scene_planes())
    pipe, _, poses = _run_pipeline(scene)
    _check(pipe, poses, scene, n, 1.5, 1.0)


def test_exposure_vignette_noise_sfm():
    """Per-view exposure swings, radial vignetting and sensor noise."""
    n = 6
    scene = render_views(n_views=n, image_size=(160, 192), arc_step=0.14)
    degraded = apply_capture_degradations(scene["images"], rng_seed=7, noise_sigma=0.02)
    assert np.abs(degraded - scene["images"]).mean() > 0.02
    pipe, _, poses = _run_pipeline(scene, images=degraded)
    _check(pipe, poses, scene, n, 1.8, 1.5)


def test_distorted_capture_e2e_as_jax():
    """The JAX test as it runs: the distorted arrays and the lens handed to
    the pipeline (image_set_from_arrays does not undistort)."""
    scene = render_views(**SCENE, dist=DIST)
    pipe, _, poses = _run_pipeline(scene, dist=DIST)
    _check(pipe, poses, scene, SCENE["n_views"], GATE["mean_reproj_px"],
           GATE["median_rel_rot_deg"])


def test_distorted_capture_e2e_undistort_at_load(tmp_path):
    """The distorted capture through the undistort-at-load path: the same
    gates, the lens consumed by the load, every colour plane through K1's
    plain version in one call on the CPU."""
    out = distorted_capture(tmp_path, "cpu")
    assert not check_gate(out), (check_gate(out), out)
    load = out["k1_by_stage"]["load"]
    assert load["kernel"] == 0 and load["plain"] == 1, load
    assert undistort_shape_key() == "18x192x256/1x49152"


def test_torch_render_matches_render_views():
    """tests/torch_render.py renders tests.render.render_views' views:
    within RENDER_ATOL through the lens, bit for bit without one."""
    ref = render_views(**SCENE, dist=DIST)
    got = torch_render.render_views(**SCENE, dist=DIST)
    for key in ("K", "Rs", "ts"):
        np.testing.assert_array_equal(got[key], ref[key])
    np.testing.assert_allclose(got["images"], ref["images"], atol=RENDER_ATOL)
    np.testing.assert_allclose(got["depth"], ref["depth"], atol=RENDER_ATOL)
    plain = dict(n_views=2, image_size=(96, 128), arc_step=0.14)
    np.testing.assert_array_equal(torch_render.render_views(**plain)["images"],
                                  render_views(**plain)["images"])


def test_distortion_render_sanity():
    """On tests/torch_render.py: the distorted render differs from the
    pinhole one away from the centre and agrees near it."""
    base = torch_render.render_views(n_views=1, image_size=(192, 256), arc_step=0.0)
    warped = torch_render.render_views(n_views=1, image_size=(192, 256), arc_step=0.0,
                                       dist=DIST)
    d = np.abs(base["images"][0] - warped["images"][0]).mean(-1)
    H, W = d.shape
    center = d[H // 2 - 20:H // 2 + 20, W // 2 - 20:W // 2 + 20]
    border = np.concatenate([d[:20].ravel(), d[-20:].ravel()])
    assert border.mean() > 5 * max(center.mean(), 1e-4)


@pytest.mark.slow
def test_global_sfm_300_views():
    """The 300-view arc through reconstruct_global, at the JAX gates."""
    n = 300
    scene = render_views(n_views=n, image_size=(96, 128), arc_step=0.004)
    iset = image_set_from_arrays(scene["images"], Camera.from_matrix(scene["K"]))
    pipe = SfMPipeline(config=ReconstructionConfig.fast(), device="cpu")
    points, _, poses = pipe.reconstruct_global(image_set=iset)
    assert len(poses) >= int(0.95 * n), f"registered {len(poses)}/{n}"
    assert len(points) > 350
    assert pipe.stats["mean_reproj_px"] < 1.2
    assert median_rel_rot_err(pipe.poses, scene["Rs"]) < 1.45


def test_calibration_on_degraded_boards():
    """Boards with noise, vignetting and strong perspective: the port's
    calibrate_camera_robust on the CPU within the JAX test's bounds."""
    from recon3d_tpu_torch.calib.calibrate import calibrate_camera_robust
    from tests.render import render_chessboard

    K_gt = np.array([[260.0, 0, 160.0], [0, 258.0, 120.0], [0, 0, 1]], np.float64)
    dist_gt = np.array([0.08, -0.15, 0.0, 0.0, 0.0])
    rng = np.random.default_rng(3)
    views = [
        (np.array([0.15, 0.3, 0.05]), np.array([-4.2, -2.6, 9.0])),
        (np.array([-0.35, 0.2, 0.1]), np.array([-3.8, -3.0, 8.0])),
        (np.array([0.3, -0.45, 0.0]), np.array([-4.5, -2.2, 10.0])),
        (np.array([-0.2, -0.3, 0.2]), np.array([-4.0, -2.8, 9.5])),
        (np.array([0.55, 0.1, -0.1]), np.array([-4.3, -2.4, 11.0])),
        (np.array([0.0, 0.55, 0.15]), np.array([-3.6, -2.9, 10.5])),
        (np.array([-0.45, -0.1, -0.2]), np.array([-4.1, -2.5, 9.8])),
        (np.array([0.1, -0.2, 0.35]), np.array([-4.4, -2.7, 10.2])),
    ]
    imgs = []
    for rvec, tvec in views:
        img = render_chessboard(K_gt, dist_gt, rvec, tvec, image_size=(240, 320))
        img = apply_capture_degradations(
            img[None, ..., None].repeat(3, -1), rng_seed=int(rng.integers(1e6)),
            noise_sigma=0.015)[0].mean(-1)
        imgs.append(img)
    result = calibrate_camera_robust(imgs, pattern=(9, 6), error_threshold=0.75,
                                     min_images=6, verbose=False, device="cpu")
    assert result is not None, "detection failed on degraded boards"
    assert len(result["used_indices"]) >= 6
    K_est = np.asarray(result["K"])
    assert abs(K_est[0, 0] - K_gt[0, 0]) / K_gt[0, 0] < 0.04
    assert abs(K_est[1, 1] - K_gt[1, 1]) / K_gt[1, 1] < 0.04
    assert abs(K_est[0, 2] - K_gt[0, 2]) < 12.0
    assert abs(K_est[1, 2] - K_gt[1, 2]) < 12.0
    assert result["overall_rms"] < 1.0


def test_jpeg_defocus_capture_sfm():
    """Every view JPEG-encoded at quality 60 and a third of them defocused
    (Gaussian PSF sigma 1.2 px)."""
    from PIL import Image
    from scipy.ndimage import gaussian_filter

    n = 6
    scene = render_views(n_views=n, image_size=(192, 256), arc_step=0.14)
    degraded = []
    for v, img in enumerate(scene["images"]):
        im = gaussian_filter(img, sigma=(1.2, 1.2, 0.0)) if v % 3 == 0 else img
        buf = io.BytesIO()
        Image.fromarray((np.clip(im, 0, 1) * 255).astype(np.uint8)).save(
            buf, format="JPEG", quality=60)
        degraded.append(np.asarray(Image.open(buf)).astype(np.float32) / 255.0)
    degraded = np.stack(degraded)
    assert np.abs(degraded - scene["images"]).mean() > 0.005
    pipe, _, poses = _run_pipeline(scene, images=degraded)
    _check(pipe, poses, scene, n, 1.8, 1.5)


@pytest.mark.slow
def test_long_span_accept_path():
    """The 2x rematch of failed long-span probes on a multi-depth occluded
    arc accepts pairs whose implied relative rotation is genuine (within
    12 deg of the truth)."""
    from recon3d_tpu_torch.ops.epipolar import essential_from_fundamental, recover_pose

    n, arc = 24, 0.026
    scene = render_views(n_views=n, image_size=(96, 128), arc_step=arc,
                         arc_offset=arc * n / 2, planes=occluded_scene_planes())
    iset = image_set_from_arrays(scene["images"], Camera.from_matrix(scene["K"]))
    pipe = SfMPipeline(config=ReconstructionConfig.fast(), device="cpu")
    pipe.set_image_set(iset)
    pipe.extract_features()
    pipe.match_image_pairs()

    w = pipe.config.sfm.match_window
    aux = [((i, j), m) for (i, j), m in pipe.matches.items()
           if m.get("aux") and j - i >= 2 * w]
    assert len(aux) >= 2, f"no accepted long-span edges: {sorted(pipe.matches)}"
    K = torch.from_numpy(scene["K"])
    for (i, j), m in aux:
        E = essential_from_fundamental(torch.from_numpy(np.asarray(m["F"], np.float32)), K)
        x1 = pipe.kp_xy[i][m["idx1"]]
        x2 = pipe.kp_xy[j][m["idx2"]]
        cap = 1 << int(np.ceil(np.log2(max(8, len(x1)))))
        x1p = np.zeros((cap, 2), np.float32)
        x2p = np.zeros((cap, 2), np.float32)
        mk = np.zeros(cap, np.float32)
        x1p[: len(x1)] = x1
        x2p[: len(x2)] = x2
        mk[: len(x1)] = 1
        R_est, _, _ = recover_pose(E, torch.from_numpy(x1p), torch.from_numpy(x2p), K,
                                   torch.from_numpy(mk))
        err = rotation_angle_deg(R_est.numpy(), scene["Rs"][j] @ scene["Rs"][i].T)
        assert err < 12.0, f"accepted edge ({i},{j}) is false: {err:.1f} deg"
