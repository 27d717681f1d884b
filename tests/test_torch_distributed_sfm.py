"""The port's multi-device SfM on the CPU, two gloo ranks spawned by
parallel.make_mesh, against the port on one device and against the JAX
package's mesh functions on the 8 virtual devices of tests/conftest.py
(mirrors tests/test_cli_mesh.py:26-52 and tests/test_bundle.py:148-170):
SIFT and neural pair matching with the pair rows sharded (bit-equal to one
device), observation-sharded bundle adjustment, and SfMPipeline(mesh=)
end to end. The CLI's --devices 2 is tests/test_torch_cli.py's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from recon3d_tpu.config import BundleConfig as JaxBundleConfig
from recon3d_tpu.config import MatchConfig as JaxMatchConfig
from recon3d_tpu.config import NeuralConfig as JaxNeuralConfig
from recon3d_tpu.features.frontend import FeatureExtractor as JaxExtractor
from recon3d_tpu.features.frontend import match_pairs_batched as jax_match_pairs_batched
from recon3d_tpu.neural.matcher import NeuralMatcher as JaxMatcher
from recon3d_tpu.parallel.mesh import auto_mesh as jax_auto_mesh
from recon3d_tpu.sfm.bundle import bundle_adjust as jax_bundle_adjust
from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import BundleConfig, MatchConfig, NeuralConfig, ReconstructionConfig
from recon3d_tpu_torch.features.frontend import match_pairs_batched
from recon3d_tpu_torch.io.dataset import image_set_from_arrays
from recon3d_tpu_torch.neural import superpoint as tsp
from recon3d_tpu_torch.neural.matcher import NeuralMatcher
from recon3d_tpu_torch.ops.sift import SiftFeatures
from recon3d_tpu_torch.parallel import make_mesh
from recon3d_tpu_torch.sfm.bundle import bundle_adjust
from recon3d_tpu_torch.sfm.pipeline import SfMPipeline
from tests.render import render_views
from tests.test_bundle import _perturbed_problem
from tests.test_torch_neural import KP, PAIRS as NEURAL_PAIRS, T, _jax_draws, gray, matchers  # noqa: F401

torch.set_num_threads(2)

SIFT_PAIRS = [(0, 1), (0, 2), (1, 2), (1, 3), (2, 3)]


@pytest.fixture(scope="module")
def mesh():
    with make_mesh(devices=2, device="cpu", timeout_s=300) as m:
        yield m


def _same(a, b):
    """Two match_pairs_batched results, bit for bit."""
    assert len(a) == len(b)
    for s, m in zip(a, b):
        assert (s[0], s[1], s[5], s[6]) == (m[0], m[1], m[5], m[6])
        for k in (2, 3, 4):
            np.testing.assert_array_equal(s[k], m[k])


@pytest.fixture(scope="module")
def jax_sift():
    """The JAX extractor's features of 4 views (tests/test_cli_mesh.py:38-42)."""
    scene = render_views(n_views=4, image_size=(96, 128), arc_step=0.2)
    return JaxExtractor().extract_batch(
        np.stack([g.mean(-1) for g in scene["images"]]).astype(np.float32))


def test_sift_match_pairs_batched_sharded_equals_single_and_jax(mesh, jax_sift):
    """The JAX features through the port's matching on two ranks: bit-equal
    to the port on one device (and the generator left where one device
    leaves it), and to the JAX mesh function on 8 devices: the same raw
    matches, inlier counts within the RANSAC draws (max(2, 10%),
    tests/test_torch_match.py)."""
    feats = SiftFeatures(**{f.name: torch.from_numpy(np.asarray(getattr(jax_sift, f.name)))
                            for f in dataclasses.fields(SiftFeatures)})
    cfg = MatchConfig()
    g1 = torch.Generator().manual_seed(3)
    single = match_pairs_batched(feats, SIFT_PAIRS, g1, cfg, chunk=4)
    g2 = torch.Generator().manual_seed(3)
    sharded = match_pairs_batched(feats, SIFT_PAIRS, g2, cfg, chunk=4, mesh=mesh)
    _same(single, sharded)
    assert torch.equal(g1.get_state(), g2.get_state())
    ref = jax_match_pairs_batched(jax_sift, SIFT_PAIRS, jax.random.PRNGKey(3), JaxMatchConfig(),
                                  mesh=jax_auto_mesh())
    for r, m in zip(ref, sharded):
        assert (r[0], r[1], r[6]) == (m[0], m[1], m[6])
        assert abs(r[5] - m[5]) <= max(2, 0.1 * r[5]), (r[5], m[5])
    assert sum(m[5] >= cfg.min_matches for m in sharded) >= 3


@pytest.mark.parametrize("kind", ["nn", "lightglue"])
def test_neural_match_pairs_batched_sharded(mesh, matchers, gray, kind):  # noqa: F811
    """NeuralMatcher.match_pairs_batched on two ranks, from a generator:
    the shards give the port on one device bit for bit (LightGlue's
    weights travel to the other rank) and leave the generator where one
    device leaves it. The nn matcher given the JAX draws also agrees with
    the JAX matcher on 8 devices as one device does (identical inliers,
    tests/test_torch_neural.py, which holds one-device LightGlue to JAX)."""
    jm0, _ = matchers
    cfg = dict(matcher=kind, max_keypoints=KP)
    jm = JaxMatcher(JaxNeuralConfig(**cfg))
    jm._sp_params, jm._lg_params = jm0._sp_params, jm0._lg_params
    tm = NeuralMatcher(NeuralConfig(**cfg), device="cpu")
    hw = (128, 160)
    feats = [jm.extract(g) for g in gray]
    tfeats = [tsp.NeuralFeatures(**{k: T(np.asarray(getattr(f, k)),
                                     torch.bool if k == "valid" else torch.float32)
                                    for k in ("xy", "score", "desc", "valid")})
              for f in feats]
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    got = tm.match_pairs_batched(tfeats, NEURAL_PAIRS, g2, chunk=2, hw=hw, mesh=mesh)
    _same(tm.match_pairs_batched(tfeats, NEURAL_PAIRS, g1, chunk=2, hw=hw), got)
    assert torch.equal(g1.get_state(), g2.get_state())
    assert all(m[5] >= 20 for m in got)
    if kind == "lightglue":
        return
    key = jax.random.PRNGKey(3)
    ref = jm.match_pairs_batched(feats, NEURAL_PAIRS, key, chunk=2, hw=hw,
                                 mesh=jax_auto_mesh())      # the chunk becomes 8
    draws = _jax_draws(jm, feats, NEURAL_PAIRS, key, 8, hw)
    got = tm.match_pairs_batched(tfeats, NEURAL_PAIRS, None, chunk=8, hw=hw,
                                 sample_indices=draws, mesh=mesh)
    for (i, j, idx1, idx2, F, n_inl, n_raw), r in zip(got, ref):
        assert (i, j, n_inl, n_raw) == (r[0], r[1], r[5], r[6])
        np.testing.assert_array_equal(idx1, r[2])
        np.testing.assert_array_equal(idx2, r[3])


def test_ba_sharded_matches_single_device_and_jax(mesh):
    """Observation-sharded BA on two ranks against one device and against
    the JAX function on 8 devices, at tests/test_bundle.py:161-170's
    bounds (rms within 0.05, points 2e-3, rotations 1e-4, translations
    1e-3)."""
    rng = np.random.default_rng(42)
    scene, poses, points, obs, kp_xy = _perturbed_problem(rng, n_cams=6, n_points=200)
    cfg = BundleConfig(max_iterations=10)
    sp, spts, ss = bundle_adjust(scene["K"], poses, points, obs, kp_xy, cfg, device="cpu")
    mp, mpts, ms = bundle_adjust(scene["K"], poses, points, obs, kp_xy, cfg, device="cpu",
                                 mesh=mesh)
    jp, jpts, js = jax_bundle_adjust(scene["K"], poses, points, obs, kp_xy,
                                     JaxBundleConfig(max_iterations=10), mesh=jax_auto_mesh())
    assert ms["rms_after"] < 0.5 and ms["num_obs"] == ss["num_obs"] == 1200
    for other_poses, other_pts, other in ((sp, spts, ss), (jp, jpts, js)):
        assert abs(ms["rms_after"] - other["rms_after"]) < 0.05
        np.testing.assert_allclose(mpts, other_pts, atol=2e-3)
        for c in other_poses:
            np.testing.assert_allclose(mp[c][0], other_poses[c][0], atol=1e-4)
            np.testing.assert_allclose(mp[c][1], other_poses[c][1], atol=1e-3)


def test_ba_padding_rows_add_nothing(mesh):
    """With a capacity far above the observations (size_hint), whole shards
    hold only zero-weight padding rows: the solve is the unpadded one's."""
    rng = np.random.default_rng(7)
    scene, poses, points, obs, kp_xy = _perturbed_problem(rng, n_cams=4, n_points=120)
    cfg = BundleConfig(max_iterations=6)
    a = bundle_adjust(scene["K"], poses, points, obs, kp_xy, cfg, device="cpu", mesh=mesh)
    b = bundle_adjust(scene["K"], poses, points, obs, kp_xy, cfg, device="cpu", mesh=mesh,
                      size_hint=(4, 120, 4096))
    assert a[2]["num_obs"] == b[2]["num_obs"] == 480
    np.testing.assert_allclose(b[1], a[1], atol=1e-5)
    assert abs(a[2]["rms_after"] - b[2]["rms_after"]) < 1e-5


def test_pipeline_reconstruct_over_the_mesh(mesh):
    """SfMPipeline(mesh=) end to end (matching and bundle adjustment on the
    two ranks) against one device: the same registered views, sparse
    points within tests/test_cli_mesh.py's 5e-3, the same colours."""
    scene = render_views(n_views=5, image_size=(128, 160), arc_step=0.15)
    images = scene["images"].astype(np.float32)

    def run(m):
        pipe = SfMPipeline(config=ReconstructionConfig(), mesh=m, device="cpu")
        iset = image_set_from_arrays(images, Camera(K=torch.from_numpy(
            np.asarray(scene["K"], np.float32)), dist=torch.zeros(5)))
        pts, cols, _ = pipe.reconstruct(image_set=iset)
        return pipe, pts, cols

    ps, pts_s, cols_s = run(None)
    pm, pts_m, cols_m = run(mesh)
    assert pm.mesh is mesh and sorted(pm.poses) == sorted(ps.poses) == list(range(5))
    assert len(pts_m) == len(pts_s) > 30
    np.testing.assert_allclose(pts_m, pts_s, atol=5e-3)
    np.testing.assert_array_equal(cols_m, cols_s)
