"""The SfM back end on the card against the same code on the CPU: the PnP
wave, the essential init and one bundle adjustment call, each given the
same pre-drawn samples on both devices.

cuSOLVER's batched eigh and svd, the parallel cumsum and the matrix
products differ from LAPACK and the CPU's sums in the last bits, so the
comparison is at the tolerances the CPU tests hold the port to against the
JAX package. Every test here is marked `cuda` and skips without a GPU. The
file imports neither jax nor the JAX package, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest tests/test_torch_back_cuda.py
"""

import numpy as np
import pytest
import torch

from recon3d_tpu_torch.config import BundleConfig
from recon3d_tpu_torch.ops import essential5, estimation, linalg, pnp
from recon3d_tpu_torch.ops import ransac
from recon3d_tpu_torch.sfm import bundle

pytestmark = pytest.mark.cuda

K = np.array([[400.0, 0, 160], [0, 400, 120], [0, 0, 1]], np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (compares the card with the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rot(w):
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def _project(X, R, t, rng, noise=0.4):
    Xc = X @ R.T + t
    return ((Xc[:, :2] / Xc[:, 2:]) * 400 + np.array([160, 120])
            + rng.normal(0, noise, (len(X), 2))).astype(np.float32)


def _both(fn, *tensors):
    """fn on the CPU and on the card, the card's result brought back."""
    on_cpu = fn(*tensors)
    on_card = fn(*[t.cuda() for t in tensors])
    return on_cpu, [r.cpu() if isinstance(r, torch.Tensor) else r for r in on_card]


def test_pnp_wave_on_the_card(cuda_device):
    """A padded wave of 4 images (one all padding) at 2,048 hypotheses
    over 3 thresholds: the same inlier masks but for points at a
    threshold's edge, poses within 1e-3."""
    rng = np.random.default_rng(0)
    P = rng.normal(size=(512, 3)).astype(np.float32) * 1.5 + np.array([0, 0, 6], np.float32)
    kp = np.zeros((1024, 2), np.float32)
    pid_idx = np.full((4, 256), -1, np.int64)
    kp_idx = np.zeros((4, 256), np.int64)
    for b, n in enumerate([80, 150, 256, 0]):
        pids = rng.choice(512, n, replace=False)
        kps = rng.choice(1024, n, replace=False)
        px = _project(P[pids], _rot([0.1 * (b + 1), -0.05, 0.02]), np.array([0.2 * b, 0.1, 0.5]), rng)
        px[: n // 4] = rng.uniform(0, 320, (n // 4, 2))
        kp[kps] = px
        pid_idx[b, :n], kp_idx[b, :n] = pids, kps
    valid = torch.from_numpy((pid_idx >= 0).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    draws = [ransac.sample_indices(gen, valid, n, k)
             for n, k in zip(pnp.pnp_hypothesis_counts(2048), (6, 3, 8))]

    def wave(Kt, Pt, kpt, pi, ki, thr, *idx):
        return estimation.estimate_pose_pnp_wave_indexed(None, Kt, Pt, kpt, pi, ki, thr,
                                                         num_hypotheses=2048, sample_indices=idx)

    cpu, card = _both(wave, torch.from_numpy(K), torch.from_numpy(P), torch.from_numpy(kp),
                      torch.from_numpy(pid_idx), torch.from_numpy(kp_idx),
                      torch.tensor([8.0, 10.0, 12.0]), *draws)
    R, t, inl, n_inl = card
    assert R.shape == (4, 3, 3, 3) and (n_inl[3] == 0).all() and (n_inl[:3, 0] >= 40).all()
    assert (inl == cpu.inliers).float().mean() >= 0.999
    np.testing.assert_allclose(R[:3].numpy(), cpu.R[:3].numpy(), atol=1e-3)
    np.testing.assert_allclose(t[:3].numpy(), cpu.t[:3].numpy(), atol=1e-3)


def test_essential_init_on_the_card(cuda_device):
    """The essential RANSAC over a batch of 3 pairs (one padded) at 512
    samples: the same E up to sign to 1e-3, the same inliers but for points
    at the threshold's edge; and the 5-point solver's null basis to 5e-5
    (five reflections, whose norms the card sums in another order)."""
    rng = np.random.default_rng(1)
    x1 = np.zeros((3, 256, 2), np.float32)
    x2 = np.zeros((3, 256, 2), np.float32)
    valid = np.zeros((3, 256), np.float32)
    for b in range(2):
        X = rng.uniform(-1.5, 1.5, (200, 3)) * np.array([1.5, 1.0, 1.0]) + np.array([0, 0, 6.0])
        x1[b, :200] = _project(X, np.eye(3), np.zeros(3), rng)
        x2[b, :200] = _project(X, _rot([0.03, -0.12 - 0.05 * b, 0.02]), np.array([0.8, 0.05, 0.1]), rng)
        x2[b, :40] = rng.uniform(0, 320, (40, 2))
        valid[b, :200] = 1.0
    valid_t = torch.from_numpy(valid)
    idx = ransac.sample_indices(torch.Generator().manual_seed(2), valid_t, 512, 5)

    def init(Kt, a, b, v, i):
        res = estimation.estimate_essential_ransac(None, Kt, a, b, v, threshold_px=2.0,
                                                   num_hypotheses=512, sample_indices=i)
        return res.E, res.inliers, res.num_inliers

    cpu, card = _both(init, torch.from_numpy(K), torch.from_numpy(x1), torch.from_numpy(x2),
                      valid_t, idx)
    E, inl, n_inl = card
    assert torch.isfinite(E).all() and int(n_inl[2]) == 0 and (n_inl[:2] >= 140).all()
    for b in range(2):
        d = min(float((E[b] - cpu[0][b]).abs().max()), float((E[b] + cpu[0][b]).abs().max()))
        assert d < 1e-3
    assert (inl == cpu[1]).float().mean() >= 0.995

    Q = essential5._epipolar_rows(torch.from_numpy(x1[0, :200].reshape(40, 5, 2) / 400),
                                  torch.from_numpy(x2[0, :200].reshape(40, 5, 2) / 400))
    np.testing.assert_allclose(linalg.null_space_rows(Q.cuda()).cpu().numpy(),
                               linalg.null_space_rows(Q).numpy(), atol=5e-5)


def test_bundle_adjust_log_on_the_card(cuda_device):
    """One BA call on the card against the CPU: the same number of accepted
    LM steps +-1, rms within 1e-2 px, poses within 1e-3 and points within
    1e-2 (the card sums the cumsum of 4,096 rows in another order)."""
    rng = np.random.default_rng(2)
    n_cams, n_points = 6, 400
    X = rng.uniform(-1.5, 1.5, (n_points, 3)) + np.array([0, 0, 6.0])
    poses, kp_xy = {}, []
    for c in range(n_cams):
        R, t = _rot([0.02, 0.08 * c + 1e-3, 0.01]), np.array([-0.4 * c, 0.02 * c, 0.1])
        kp_xy.append(_project(X, R, t, rng, noise=0.3))
        dR = _rot(rng.normal(scale=0.01, size=3)) if c else np.eye(3)
        poses[c] = ((dR @ R).astype(np.float32),
                    (t + (rng.normal(scale=0.01, size=3) if c else 0)).astype(np.float32))
    points = (X + rng.normal(scale=0.02, size=X.shape)).astype(np.float32)
    log = np.asarray([(p, c, p) for p in range(n_points) for c in range(n_cams)], np.int32)
    log = log[rng.permutation(len(log))]
    kp_off = np.arange(n_cams + 1, dtype=np.int64) * n_points
    table = (np.concatenate(kp_xy), kp_off)
    out = {}
    for dev in ("cpu", "cuda"):
        cache = {}
        first = bundle.bundle_adjust_log(K, poses, points, log[:2000], table,
                                         BundleConfig(max_iterations=4), device_cache=cache,
                                         device=dev)
        assert cache["log"]["cam"].device.type == dev and cache["log"]["count"] == 2000
        out[dev] = bundle.bundle_adjust_log(K, poses, points, log, table,
                                            BundleConfig(max_iterations=10), device_cache=cache,
                                            device=dev)                  # the tail-upload path
        assert cache["log"]["count"] == len(log) and first[2]["iterations"] >= 1
    (p_cpu, x_cpu, s_cpu), (p_card, x_card, s_card) = out["cpu"], out["cuda"]
    assert s_card["rms_after"] < 0.5 and abs(s_card["rms_after"] - s_cpu["rms_after"]) < 1e-2
    assert abs(s_card["iterations"] - s_cpu["iterations"]) <= 1
    assert s_card["num_obs"] == s_cpu["num_obs"] == len(log)
    np.testing.assert_allclose(x_card, x_cpu, atol=1e-2)
    for c in p_cpu:
        np.testing.assert_allclose(p_card[c][0], p_cpu[c][0], atol=1e-3)
        np.testing.assert_allclose(p_card[c][1], p_cpu[c][1], atol=1e-3)
