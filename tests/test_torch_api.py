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


SUBPACKAGES = ("calib", "dense", "features", "io", "ops", "parallel", "runtime", "sfm")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_match_the_jax_package(sub):
    """Each subpackage's __all__ is the JAX package's, and every name binds
    the port's object of the same name."""
    import importlib

    jmod = importlib.import_module(f"recon3d_tpu.{sub}")
    tmod = importlib.import_module(f"recon3d_tpu_torch.{sub}")
    assert tmod.__all__ == jmod.__all__
    for name in tmod.__all__:
        got, ref = getattr(tmod, name), getattr(jmod, name)
        if hasattr(ref, "__name__"):
            assert got.__name__ == ref.__name__
            assert got.__module__.startswith("recon3d_tpu_torch.")
        else:
            assert got == ref


def test_neural_exports_hold_the_jax_names():
    """The neural subpackage exports the JAX package's three names and,
    beyond them, the training API that the JAX package keeps in its
    modules (neural/train.py, neural/weights.py)."""
    import recon3d_tpu.neural as jneural
    import recon3d_tpu_torch.neural as tneural

    assert tneural.__all__[:3] == jneural.__all__
    assert tneural.HAS_NEURAL is True
    for name in tneural.__all__:
        assert getattr(tneural, name) is not None


def test_shard_batch_and_sharding_records():
    """parallel's JAX names on the port's mesh: pad_to_multiple is the
    numpy copy, and shard_batch gives each rank the rows of a 'data'
    sharding (shard_rows), as jax.device_put of data_sharding places them."""
    from recon3d_tpu.parallel import pad_to_multiple as jax_pad
    from recon3d_tpu_torch.parallel import (
        data_sharding, make_mesh, pad_to_multiple, replicated, shard_batch)
    from recon3d_tpu_torch.parallel.mesh import Mesh

    x = np.arange(30, dtype=np.float32).reshape(5, 6)
    for axis, m in ((0, 4), (1, 4), (0, 5)):
        got, n = pad_to_multiple(x, m, axis)
        ref, nj = jax_pad(x, m, axis)
        np.testing.assert_array_equal(got, ref)
        assert n == nj
    with make_mesh(devices=1, device="cpu") as mesh:
        s = data_sharding(mesh, 3, axis=1)
        assert (s.mesh, s.ndim, s.axis) == (mesh, 3, 1) and replicated(mesh).axis is None
        t = shard_batch(x, mesh)
        assert torch.equal(t, torch.from_numpy(x)) and t.device == mesh.device
    rows = []
    for rank in range(2):
        m = Mesh(shape={"data": 2, "model": 1}, rank=rank, device=torch.device("cpu"),
                 backend="gloo", share_device=False, timeout_s=1.0)
        rows.append(shard_batch(x, m, axis=1).numpy())
    np.testing.assert_array_equal(rows[0], x[:, :3])
    np.testing.assert_array_equal(rows[1], x[:, 3:])


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
from recon3d_tpu_torch.calib import *
from recon3d_tpu_torch.dense import *
from recon3d_tpu_torch.features import *
from recon3d_tpu_torch.io import *
from recon3d_tpu_torch.ops import *
from recon3d_tpu_torch.parallel import *
from recon3d_tpu_torch.runtime import *
from recon3d_tpu_torch.sfm import *
import recon3d_tpu_torch.serve, recon3d_tpu_torch.runtime.warmup
import recon3d_tpu_torch.gui.app, recon3d_tpu_torch.tools.run_colmap
from recon3d_tpu_torch.kernels import bundle, warp
assert sorted(recon3d_tpu_torch.__all__) == sorted(n for n in dir() if n in recon3d_tpu_torch.__all__)
print("COUNTS", warp.counts.kernel, warp.counts.plain, warp._lib is None)
print("BUNDLE", bundle.counts.kernel, bundle._lib is None)
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
    assert "BUNDLE 0 True" in r.stdout, r.stdout
    assert listing() == before
