"""The SfM pipeline's padding buckets (sfm/pipeline.py `_pad_pow2`) and a
registration wave against a point table larger than the largest
geometric bucket: the bucket never falls below the size it pads, past
`hi` it grows by multiples of `hi`, and below `hi` it is what it was."""

import numpy as np
import pytest
import torch

from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.sfm.pipeline import SfMPipeline, _pad_pow2

torch.set_num_threads(2)


@pytest.mark.parametrize("n, kw, bucket", [
    (0, {}, 256), (256, {}, 256), (257, {}, 1024), (9_500, {}, 16_384), (16_384, {}, 16_384),
    (16_385, {}, 32_768), (17_539, {}, 32_768), (40_000, {}, 49_152),
    (3, {"lo": 1, "hi": 1024}, 4), (1024, {"lo": 1, "hi": 1024}, 1024),
    (1500, {"lo": 1, "hi": 1024}, 2048), (3000, {"lo": 2, "hi": 4096}, 8192),
    (9000, {"lo": 2, "hi": 4096}, 12_288), (70, {"lo": 64}, 256),
])
def test_the_bucket_holds_the_size(n, kw, bucket):
    assert _pad_pow2(n, **kw) == bucket >= n


def test_a_wave_registers_against_more_than_16384_points():
    """An image seen at 600 of 17,539 points (the size that crashed the
    wave's (P, 3) table at DTU's density) registers at its true pose."""
    rng = np.random.default_rng(7)
    P = np.stack([rng.uniform(-1.5, 1.5, 17_539), rng.uniform(-1.0, 1.0, 17_539),
                  rng.uniform(4.0, 6.0, 17_539)], axis=1).astype(np.float32)
    K = np.array([[300.0, 0.0, 160.0], [0.0, 300.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
    a = 0.1
    R = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0], [-np.sin(a), 0.0, np.cos(a)]],
                 np.float32)
    t = np.array([0.2, -0.1, 0.3], np.float32)
    pids = np.sort(rng.choice(len(P), 600, replace=False))
    Xc = P[pids] @ R.T + t
    xy = (Xc[:, :2] / Xc[:, 2:] * [300.0, 300.0] + [160.0, 120.0]).astype(np.float32)
    xy += rng.normal(0.0, 0.2, xy.shape).astype(np.float32)

    pipe = SfMPipeline(device="cpu")
    pipe.camera = Camera.from_matrix(torch.from_numpy(K))
    pipe.kp_xy = [np.zeros((4, 2), np.float32), np.zeros((4, 2), np.float32), xy]
    pipe.kp_to_point = [np.full(len(k), -1, np.int64) for k in pipe.kp_xy]
    pipe.features = [None] * 3
    pipe.points3d = P
    pipe.observations = [[] for _ in range(len(P))]
    accepted = pipe._register_wave([(2, np.arange(len(pids)), pids)])
    assert accepted == [2]
    R_est, t_est = pipe.poses[2]
    assert np.abs(R_est - R).max() < 1e-2 and np.abs(t_est - t).max() < 5e-2
    assert (pipe.kp_to_point[2] >= 0).sum() > 500
