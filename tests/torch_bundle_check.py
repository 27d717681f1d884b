"""The bundle adjustment kernels (csrc/bundle.cu) on the card at DTU's size:
the problem of tests/test_torch_bundle_cuda.py and chip_smoke.py's bundle
phase, and each kernel's byte bound on the live rows.

numpy and torch only (no jax): chip_smoke.py imports it on a machine
without JAX.

  dtu_table(device, cap, seed)  49 cameras, 10,000 points, 50,000 rows
  float64(data), rel(got, want)
  kernel_bytes(rows, P, C)      bytes each kernel needs at least
"""

from __future__ import annotations

import numpy as np
import torch

N_CAMS, N_POINTS, VIEWS_A_POINT, CAP = 49, 10_000, 5, 262_144
CG_ITERS, DAMPING, DELTA = 24, 1e-3, 3.0


def _rot(w):
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def dtu_log(seed: int = 0):
    """(K, R0, t0, X0 padded to the pipeline's buckets, the raw log (cam,
    pid, xy) in arrival order, row_of): cameras on an arc of 1.7 rad around
    a box of points, each point seen by VIEWS_A_POINT neighbouring cameras
    with 0.5 px noise and 3% outliers; poses and points perturbed as the
    pipeline's intermediate BAs find them."""
    rng = np.random.default_rng(seed)
    K = np.array([[1440.0, 0, 800], [0, 1440, 600], [0, 0, 1]], np.float32)
    X = rng.uniform(-0.4, 0.4, (N_POINTS, 3)) * np.array([1.0, 1.0, 0.5])
    angles = np.linspace(-0.85, 0.85, N_CAMS)
    Rs = [_rot([0.05, a, 0.0]) for a in angles]
    ts = [np.array([0.0, 0.0, 2.5]) for _ in angles]
    first = rng.integers(0, N_CAMS - VIEWS_A_POINT + 1, N_POINTS)
    pid = np.repeat(np.arange(N_POINTS), VIEWS_A_POINT)
    cam = (first[:, None] + np.arange(VIEWS_A_POINT)[None]).reshape(-1)
    Xc = np.einsum("oij,oj->oi", np.stack(Rs)[cam], X[pid]) + np.stack(ts)[cam]
    xy = Xc[:, :2] / Xc[:, 2:] * 1440 + np.array([800, 600]) + rng.normal(0, 0.5, (len(pid), 2))
    bad = rng.random(len(pid)) < 0.03
    xy[bad] += rng.normal(0, 25, (int(bad.sum()), 2))
    order = rng.permutation(len(pid))
    C, P = 64, 16_384
    R0 = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    t0 = np.zeros((C, 3), np.float32)
    t0[:, 2] = 1.0
    for c in range(N_CAMS):
        dR = _rot(rng.normal(scale=0.003, size=3)) if c else np.eye(3)
        R0[c] = dR @ Rs[c]
        t0[c] = ts[c] + (rng.normal(scale=0.005, size=3) if c else 0)
    X0 = np.zeros((P, 3), np.float32)
    X0[:N_POINTS] = X + rng.normal(scale=0.003, size=X.shape)
    row_of = np.full(C, -1, np.int64)
    row_of[:N_CAMS] = np.arange(N_CAMS)
    return K, R0, t0, X0, (cam[order], pid[order], xy[order].astype(np.float32)), row_of


def dtu_table(device, cap: int = CAP, seed: int = 0):
    """The DTU-sized problem as the pipeline's table: the log padded to
    `cap` rows, built on `device` by sfm/bundle.py::_obs_table."""
    from recon3d_tpu_torch.sfm import bundle

    K, R0, t0, X0, (cam, pid, xy), row_of = dtu_log(seed)
    O = len(cam)
    log_cam, log_pid = np.zeros(cap, np.int64), np.zeros(cap, np.int64)
    log_xy = np.zeros((cap, 2), np.float32)
    log_cam[:O], log_pid[:O], log_xy[:O] = cam, pid, xy

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return bundle._obs_table(t(K), t(R0), t(t0), t(X0), t(log_cam), t(log_pid), t(log_xy), O,
                             t(row_of))


def float64(data):
    return data._replace(**{k: getattr(data, k).double()
                            for k in ("K", "R0", "t0", "X0", "obs_xy", "obs_w")})


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.norm(got.double() - want.double()) / torch.linalg.norm(want.double()))


def kernel_bytes(rows: int, P: int, C: int) -> dict:
    """The bytes each kernel of one LM step must move at least, over `rows`
    live rows, P points and C cameras: every input it needs read once,
    every output written once (csrc/bundle.cu's records and sums; an index
    8 bytes, a float 4). A row's record is 96 bytes point-major and 80
    camera-major; passes A and B read the first 80 of it."""
    seg = 16                        # a segment's [start, end)
    cam_state = 6 * 4               # one camera vector
    return {
        "linearize": rows * (8 + 8 + 4 + 96) + P * (12 + seg + 10 * 4) + C * 48,
        "point_setup": P * (10 * 4 + 12 * 4),
        "cam_setup": rows * (8 + 96 + 80) + P * 12 * 4 + C * (seg + 40 * 4),
        "cg_init": C * (40 * 4 + 36 * 4 + 5 * cam_state) + P * 4,
        "point_pass": rows * 80 + P * (seg + 16) + C * cam_state,
        "cam_pass": rows * 80 + P * (6 * 4 + 16) + C * (seg + 2 * cam_state),
        "cg_update": C * (36 * 4 + 2 * cam_state + 4 * 2 * cam_state + cam_state),
        "point_update": P * (12 * 4 + 16 + 12),
        "cost": rows * (16 + 8) + P * (12 + 12 + seg + 4) + C * 48,
        "half_sum": P * 4,
    }
