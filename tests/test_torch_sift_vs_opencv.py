"""tests/test_sift_vs_opencv.py on the port: its SIFT front end against
OpenCV's on two rendered views, at the JAX test's gates. The port
verifies at least as many matches as OpenCV's SIFT + ratio test + RANSAC
pipeline, at a median distance to the true epipolar lines within twice
OpenCV's (or 0.5 px)."""

import numpy as np
import pytest
import torch

from recon3d_tpu_torch.config import MatchConfig, SiftConfig
from recon3d_tpu_torch.features.frontend import FeatureExtractor, match_pairs_batched
from tests.render import render_views

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(2)


def _gt_epipolar_err(scene, p1, p2):
    K = scene["K"]
    R1, t1 = scene["Rs"][0], scene["ts"][0]
    R2, t2 = scene["Rs"][1], scene["ts"][1]
    R = R2 @ R1.T
    t = t2 - R @ t1
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Fgt = np.linalg.inv(K).T @ (tx @ R) @ np.linalg.inv(K)
    line = np.concatenate([p1, np.ones((len(p1), 1))], 1) @ Fgt.T
    num = np.abs(np.sum(line * np.concatenate([p2, np.ones((len(p2), 1))], 1), 1))
    return num / np.linalg.norm(line[:, :2], axis=1)


def test_sift_matches_opencv_quality():
    scene = render_views(n_views=2, image_size=(240, 320), arc_step=0.12)
    g8 = [(scene["images"][i].mean(-1) * 255).astype(np.uint8) for i in range(2)]

    sift = cv2.SIFT_create(nfeatures=2000, contrastThreshold=0.03, edgeThreshold=15)
    kp1, d1 = sift.detectAndCompute(g8[0], None)
    kp2, d2 = sift.detectAndCompute(g8[1], None)
    good = [m for m, n in cv2.BFMatcher().knnMatch(d1, d2, k=2)
            if m.distance < 0.75 * n.distance]
    p1 = np.float32([kp1[m.queryIdx].pt for m in good])
    p2 = np.float32([kp2[m.trainIdx].pt for m in good])
    _, inl = cv2.findFundamentalMat(p1, p2, cv2.FM_RANSAC, 2.0, 0.999)
    n_cv = int(inl.sum()) if inl is not None else 0
    e_cv = _gt_epipolar_err(scene, p1[inl.ravel() == 1], p2[inl.ravel() == 1])

    ex = FeatureExtractor(SiftConfig(max_features=2048, contrast_threshold=0.03), device="cpu")
    f1 = ex.extract(scene["images"][0].mean(-1).astype(np.float32))
    f2 = ex.extract(scene["images"][1].mean(-1).astype(np.float32))
    (_, _, idx1, idx2, _, n_ours, _) = match_pairs_batched(
        [f1, f2], [(0, 1)], torch.Generator().manual_seed(0), MatchConfig())[0]
    e_ours = _gt_epipolar_err(scene, f1.xy.numpy()[idx1], f2.xy.numpy()[idx2])

    assert n_ours >= n_cv, f"ours {n_ours} vs cv2 {n_cv}"
    assert np.median(e_ours) < max(2.0 * np.median(e_cv), 0.5), (
        f"ours {np.median(e_ours):.3f}px vs cv2 {np.median(e_cv):.3f}px")
