"""The port's public API against the JAX package's: the names the package
exports, the camera and pose methods, projection_from_KRt and
undistort_points on the same random batched inputs, and an import that
builds no kernel."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recon3d_tpu
import recon3d_tpu_torch
from recon3d_tpu import camera as jcam
from recon3d_tpu.ops.image import distort_points as jax_distort_points
from recon3d_tpu.ops.image import undistort_points as jax_undistort_points
from recon3d_tpu_torch import camera as tcam
from recon3d_tpu_torch.ops.image import distort_points, undistort_points

REPO = Path(__file__).resolve().parent.parent


def test_exports_match_the_jax_package():
    assert recon3d_tpu_torch.__all__ == recon3d_tpu.__all__
    assert recon3d_tpu_torch.__version__ == recon3d_tpu.__version__
    for name in recon3d_tpu_torch.__all__:
        assert getattr(recon3d_tpu_torch, name).__name__ == getattr(recon3d_tpu, name).__name__


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], 1).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    """Two cameras (with skew) and two poses, batched, and points for each
    pose (2, 50, 3); points and pixels for the cameras (50, 2, ...), whose
    batch axis broadcasts from the right as the JAX methods' does."""
    rng = np.random.default_rng(7)
    K = np.zeros((2, 3, 3), np.float32)
    K[:, 0, 0] = rng.uniform(300, 600, 2)
    K[:, 1, 1] = rng.uniform(300, 600, 2)
    K[:, 0, 1] = rng.uniform(-2, 2, 2)
    K[:, 0, 2] = rng.uniform(150, 330, 2)
    K[:, 1, 2] = rng.uniform(100, 250, 2)
    K[:, 2, 2] = 1.0
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {
        "K": K, "dist": f32(rng.normal(0, 0.05, (2, 5))),
        "R": _rotations(rng, 2), "t": f32(rng.normal(size=(2, 3))),
        "R2": _rotations(rng, 2), "t2": f32(rng.normal(size=(2, 3))),
        "X": np.concatenate([f32(rng.uniform(-2, 2, (2, 50, 2))),
                             f32(rng.uniform(1, 5, (2, 50, 1)))], -1),
        "Xc": np.concatenate([f32(rng.uniform(-2, 2, (50, 2, 2))),
                              f32(rng.uniform(1, 5, (50, 2, 1)))], -1),
        "pix": f32(rng.uniform(0, 640, (50, 2, 2))),
        "depth": f32(rng.uniform(0.5, 10, (50, 2))),
    }


def _both(inputs, case):
    """(the JAX result, the port's result) of one API call, as numpy."""
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    out = []
    for m, a in ((jcam, j), (tcam, t)):
        cam = m.Camera(K=a["K"], dist=a["dist"])
        pose = m.CameraPose(R=a["R"], t=a["t"])
        other = m.CameraPose(R=a["R2"], t=a["t2"])
        r = {
            "fx": lambda: cam.fx, "fy": lambda: cam.fy, "cx": lambda: cam.cx,
            "cy": lambda: cam.cy,
            "project": lambda: cam.project(a["Xc"]),
            "unproject": lambda: cam.unproject(a["pix"], a["depth"]),
            "unproject_scalar_depth": lambda: cam.unproject(a["pix"], 2.5),
            "normalized": lambda: cam.normalized(a["pix"]),
            "scaled": lambda: cam.scaled(0.25).K,
            "identity": lambda: m.CameraPose.identity((2, 3)).R,
            "identity_t": lambda: m.CameraPose.identity((4,)).t,
            "center": lambda: pose.center,
            "projection_matrix": lambda: pose.projection_matrix,
            "transform_points": lambda: pose.transform_points(a["X"]),
            "inverse_R": lambda: pose.inverse().R,
            "inverse_t": lambda: pose.inverse().t,
            "compose_R": lambda: pose.compose(other).R,
            "compose_t": lambda: pose.compose(other).t,
            "look_at": lambda: pose.look_at(),
            "projection_from_KRt": lambda: m.projection_from_KRt(a["K"], a["R"], a["t"]),
        }[case]()
        out.append(np.asarray(r))
    return out


@pytest.mark.parametrize("case", [
    "fx", "fy", "cx", "cy", "project", "unproject", "unproject_scalar_depth",
    "normalized", "scaled", "identity", "identity_t", "center", "projection_matrix",
    "transform_points", "inverse_R", "inverse_t", "compose_R", "compose_t", "look_at",
    "projection_from_KRt",
])
def test_camera_api_matches_jax(inputs, case):
    """To 1e-6 of the result's largest magnitude: K [R | t] sums products of
    ~500 that cancel to ~1, where float32 products summed in another order
    differ by a few units in the last place of the terms."""
    ref, got = _both(inputs, case)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * max(1.0, np.abs(ref).max()))


def test_undistort_points_matches_jax():
    rng = np.random.default_rng(3)
    dist = np.float32([0.12, -0.4, 0.006, 0.003, 0.01])
    d = np.float32(rng.uniform(-0.4, 0.4, size=(3, 100, 2)))
    for it in (1, 8, 20):
        ref = np.asarray(jax_undistort_points(jnp.asarray(d), jnp.asarray(dist), iterations=it))
        got = undistort_points(torch.from_numpy(d), torch.from_numpy(dist), iterations=it)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    # tests/test_image_ops.py::test_distort_undistort_roundtrip on the port
    pts = np.float32(rng.uniform(-0.4, 0.4, size=(100, 2)))
    back = undistort_points(distort_points(torch.from_numpy(pts), torch.from_numpy(dist)),
                            torch.from_numpy(dist), iterations=20)
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-5)
    np.testing.assert_allclose(
        distort_points(torch.from_numpy(pts), torch.from_numpy(dist)).numpy(),
        np.asarray(jax_distort_points(jnp.asarray(pts), jnp.asarray(dist))), rtol=0, atol=1e-6)


_IMPORT_PROBE = """
import sys
from recon3d_tpu_torch import *
import recon3d_tpu_torch
from recon3d_tpu_torch.kernels import warp
assert sorted(recon3d_tpu_torch.__all__) == sorted(n for n in dir() if n in recon3d_tpu_torch.__all__)
print("COUNTS", warp.counts.kernel, warp.counts.plain, warp._lib is None)
print("JAX", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "recon3d_tpu")))
"""


def test_import_builds_no_kernel():
    build = REPO / "recon3d_tpu_torch" / "_build"

    def listing():
        return sorted((p.name, p.stat().st_mtime_ns) for p in build.iterdir()) \
            if build.exists() else None

    before = listing()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "COUNTS 0 0 True" in r.stdout and "JAX []" in r.stdout, r.stdout
    assert listing() == before
