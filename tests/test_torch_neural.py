"""The neural front end of the port (recon3d_tpu_torch/neural: SuperPoint,
LightGlue, NeuralMatcher, the pipeline's neural_mode) against the JAX
package's (recon3d_tpu/neural) on the CPU, with the bundled checkpoints.

Per function the same numpy inputs go through the jitted JAX function and
the port. Convolutions and matrix products sum in another order in XLA
and in PyTorch, so the networks are held to tolerances stated with each
test; the selections downstream of them (NMS, top-k, mutual argmax) are
fed the same scores and held to equality. End to end the port is held to
the outcomes that tests/test_neural_bundled.py holds the JAX pipeline to.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recon3d_tpu.config import NeuralConfig as JaxNeuralConfig
from recon3d_tpu.neural import lightglue as jlg
from recon3d_tpu.neural import superpoint as jsp
from recon3d_tpu.neural.matcher import NeuralMatcher as JaxMatcher
from recon3d_tpu.ops.match import match_descriptors as jax_match_descriptors
from recon3d_tpu.ops.ransac import sample_indices as jax_sample_indices
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import NeuralConfig, ReconstructionConfig
from recon3d_tpu_torch.io.dataset import image_set_from_arrays
from recon3d_tpu_torch.neural import lightglue as tlg
from recon3d_tpu_torch.neural import superpoint as tsp
from recon3d_tpu_torch.neural.matcher import (
    BUNDLED_LIGHTGLUE,
    BUNDLED_SUPERPOINT,
    NeuralMatcher,
)
from recon3d_tpu_torch.neural.weights import save_params_npz
from recon3d_tpu_torch.sfm.pipeline import SfMPipeline
from tests.render import render_views
from tests.torch_public_weights import superpoint_state_dict

torch.set_num_threads(2)

KP = 256   # keypoint capacity of the per-function tests


def T(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


@pytest.fixture(scope="module")
def gray():
    scene = render_views(n_views=3, image_size=(128, 160), arc_step=0.15)
    return scene["images"] @ np.array([0.299, 0.587, 0.114], np.float32)


def _flax_params(path):
    """The Flax parameter tree of a save_params_npz file, float32 as the JAX
    loader restores it (without initialising a template first)."""
    tree = {}
    for key, arr in convert.read_params_npz(path).items():
        *parents, leaf = key.split("/")
        node = tree
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = jnp.asarray(arr.astype(np.float32))
    return tree


@pytest.fixture(scope="module")
def matchers():
    """The JAX and the port's NeuralMatcher with the bundled SuperPoint and
    LightGlue at full width (9 layers, dim 256, 4 heads) and KP slots."""
    cfg = dict(matcher="lightglue", max_keypoints=KP)
    jm = JaxMatcher(JaxNeuralConfig(**cfg))
    jm._sp_params = _flax_params(BUNDLED_SUPERPOINT)
    jm._lg_params = _flax_params(BUNDLED_LIGHTGLUE)
    tm = NeuralMatcher(NeuralConfig(**cfg), device="cpu")
    tm._ensure_params()
    return jm, tm


# -- weights -------------------------------------------------------------------


@pytest.mark.parametrize("which", ["superpoint", "lightglue"])
def test_bundled_weights_convert_completely(which):
    """Every key of the bundled file consumed, every parameter of the port's
    module set, values equal to the float16 ones stored (conv kernels
    HWIO -> OIHW, Dense kernels transposed)."""
    path = BUNDLED_SUPERPOINT if which == "superpoint" else BUNDLED_LIGHTGLUE
    module = tsp.SuperPointNet() if which == "superpoint" else tlg.LightGlueNet()
    flat = convert.read_params_npz(path)
    assert len(flat) == (24 if which == "superpoint" else 511)
    sd = convert.flax_to_state_dict(flat, module)
    assert set(sd) == set(dict(module.named_parameters()))
    assert all(v.dtype == torch.float32 for v in sd.values())
    if which == "superpoint":
        k = flat["params/conv2a/kernel"].astype(np.float32)
        np.testing.assert_array_equal(sd["conv2a.weight"].numpy(), k.transpose(3, 2, 0, 1))
    else:
        k = flat["params/layer3/cross_upd1/ffn2/kernel"].astype(np.float32)
        np.testing.assert_array_equal(sd["layer3.cross_upd1.ffn2.weight"].numpy(), k.T)
        np.testing.assert_array_equal(sd["layer3.cross_upd1.ln.weight"].numpy(),
                                      flat["params/layer3/cross_upd1/ln/scale"])
        assert sd["rotary_freqs"].shape == (2, 32)
    convert.load_params_npz(path, module)


def test_weight_conversion_refuses_incomplete_or_foreign_files(tmp_path):
    flat = convert.read_params_npz(BUNDLED_SUPERPOINT)
    net = tsp.SuperPointNet()
    missing = {k: v for k, v in flat.items() if k != "params/convPb/bias"}
    with pytest.raises(KeyError, match="misses"):
        convert.flax_to_state_dict(missing, net)
    with pytest.raises(KeyError, match="matches no parameter"):
        convert.flax_to_state_dict({**flat, "params/conv9/bias": np.zeros(3)}, net)
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.flax_to_state_dict(flat, tsp.SuperPointNet(descriptor_dim=128))
    # a torch .pth in the public layout loads through convert and NeuralMatcher
    # (the suffix decides, as in the JAX matcher) and gives the forward of
    # the same weights written as an .npz
    torch.save(superpoint_state_dict(), tmp_path / "sp.pth")
    save_params_npz(convert.load_params_npz(tmp_path / "sp.pth", tsp.SuperPointNet()),
                    str(tmp_path / "sp.npz"))
    img = np.random.default_rng(2).random((64, 64)).astype(np.float32)
    feats = [NeuralMatcher(NeuralConfig(superpoint_weights=str(tmp_path / name),
                                        max_keypoints=64), device="cpu").extract(img)
             for name in ("sp.pth", "sp.npz")]
    for f in ("xy", "score", "desc", "valid"):
        assert torch.equal(getattr(feats[0], f), getattr(feats[1], f)), f
    # an empty .pth still raises, with torch's own load error
    (tmp_path / "w.pth").write_bytes(b"")
    with pytest.raises(EOFError):
        convert.read_params_npz(tmp_path / "w.pth", tsp.SuperPointNet())
    with pytest.raises(EOFError):
        NeuralMatcher(NeuralConfig(superpoint_weights=str(tmp_path / "w.pth")),
                      device="cpu").extract(np.zeros((64, 64), np.float32))


def test_matcher_kind_and_weight_errors_follow_jax():
    assert NeuralMatcher(NeuralConfig(), device="cpu").matcher_kind == "nn"
    assert NeuralMatcher(NeuralConfig(lightglue_weights="x.npz"),
                         device="cpu").matcher_kind == "lightglue"
    bad = NeuralMatcher(NeuralConfig(matcher="lightglue", descriptor_dim=128), device="cpu")
    with pytest.raises(RuntimeError, match="does not fit"):
        bad._ensure_params()
    auto = NeuralMatcher(NeuralConfig(descriptor_dim=128), device="cpu")
    auto._ensure_params()
    assert auto.matcher_kind == "nn"
    with pytest.raises(NotImplementedError, match="item 12"):
        NeuralMatcher(device="cpu").match_pairs_batched([], [], None, mesh=object())


# -- SuperPoint ----------------------------------------------------------------


def test_superpoint_network_matches_jax(matchers, gray):
    """Logits within 2e-4 of their range and unit descriptors within 1e-4,
    with the bundled weights on a 128x160 image."""
    jm, tm = matchers
    x = gray[0][None, ..., None]
    lj, dj = jax.jit(jm.sp.apply)(jm._sp_params, jnp.asarray(x))
    with torch.no_grad():
        lt, dt = tm.sp(T(x))
    lj, dj = np.asarray(lj), np.asarray(dj)
    assert lt.shape == lj.shape == (1, 16, 20, 65) and dt.shape == dj.shape == (1, 16, 20, 256)
    np.testing.assert_allclose(lt.numpy(), lj, atol=2e-4 * np.ptp(lj))
    np.testing.assert_allclose(dt.numpy(), dj, atol=1e-4)


def test_scores_and_nms_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(scale=3.0, size=(2, 6, 7, 65)).astype(np.float32)
    ref = np.asarray(jax.jit(jsp.scores_from_logits)(jnp.asarray(logits)))
    got = tsp.scores_from_logits(T(logits)).numpy()
    assert got.shape == (2, 48, 56)
    # the two libraries' softmax (exp and sum) differ by up to 3 ulp; the
    # depth-to-space placement is exact: every pixel's value is its own
    np.testing.assert_allclose(got, ref, rtol=5e-7, atol=0)
    np.testing.assert_array_equal(got.argsort(axis=None, kind="stable")[-500:],
                                  ref.argsort(axis=None, kind="stable")[-500:])
    # NMS of the same map: exact, with plateaus (equal neighbours kept)
    s = np.round(rng.random((2, 40, 52)) * 8).astype(np.float32) / 8
    for r in (1, 4):
        ref = np.asarray(jax.jit(jsp.simple_nms, static_argnums=1)(jnp.asarray(s), r))
        np.testing.assert_array_equal(tsp.simple_nms(T(s), r).numpy(), ref)


def test_detect_keypoints_identical_on_the_same_score_map(matchers, gray):
    """The JAX network's score map and coarse descriptors through both
    detect_keypoints: the same slots (positions, scores, validity) and
    descriptors within 1e-6."""
    jm, _ = matchers
    logits, desc = jax.jit(jm.sp.apply)(jm._sp_params, jnp.asarray(gray[1][None, ..., None]))
    scores = np.asarray(jsp.scores_from_logits(logits))[0]
    desc = np.asarray(desc)[0]
    for k in (KP, 2048):
        ref = jax.jit(jsp.detect_keypoints, static_argnums=2)(
            jnp.asarray(scores), jnp.asarray(desc), k)
        got = tsp.detect_keypoints(T(scores), T(desc), k)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_array_equal(got.score.numpy(), np.asarray(ref.score))
        np.testing.assert_array_equal(got.xy.numpy(), np.asarray(ref.xy))
        np.testing.assert_allclose(got.desc.numpy(), np.asarray(ref.desc), atol=1e-6)
    assert 30 < int(got.valid.sum()) < 2048
    sift = tsp.neural_to_sift_features(got)
    assert sift.scale.shape == (2048,) and float(sift.angle[0]) == -1.0


def test_extract_matches_jax_keypoints(matchers, gray):
    """NeuralMatcher.extract end to end: the valid keypoints of both within
    0.05 px and 98% of them in the same slots (a score near a tie can swap
    with its neighbour under the networks' float differences)."""
    jm, tm = matchers
    for g in gray:
        ref = jm.extract(g)
        got = tm.extract(g)
        rv, gv = np.asarray(ref.valid), got.valid.numpy()
        assert abs(int(rv.sum()) - int(gv.sum())) <= 2
        both = rv & gv
        same = np.linalg.norm(got.xy.numpy() - np.asarray(ref.xy), axis=1) < 0.05
        assert (same & both).sum() >= 0.98 * rv.sum()


# -- LightGlue -----------------------------------------------------------------


def _lightglue_inputs(matchers, gray):
    jm, _ = matchers
    f = [jm.extract(g) for g in gray[:2]]
    return [{k: np.asarray(getattr(x, k)) for k in ("xy", "desc", "valid")} for x in f]


def test_lightglue_full_width_matches_jax(matchers, gray):
    """The bundled LightGlue at full width on two sets of KP keypoints (the
    invalid slots masked): log-assignment within 2e-3 of its magnitude on
    the valid block, matchability within 1e-4."""
    jm, tm = matchers
    a, b = _lightglue_inputs(matchers, gray)
    hw = (128, 160)
    args = (a["desc"], b["desc"], np.asarray(jlg.normalize_keypoints(a["xy"], hw)),
            np.asarray(jlg.normalize_keypoints(b["xy"], hw)), a["valid"], b["valid"])
    la, m0, m1 = jax.jit(jm.lg.apply)(jm._lg_params, *(jnp.asarray(x) for x in args))
    la, m0, m1 = np.asarray(la), np.asarray(m0), np.asarray(m1)
    with torch.no_grad():
        xy0 = tlg.normalize_keypoints(T(a["xy"])[None], hw)
        np.testing.assert_allclose(xy0[0].numpy(), args[2], rtol=0, atol=1e-7)
        lt, t0, t1 = tm.lg(T(a["desc"])[None], T(b["desc"])[None], xy0,
                           tlg.normalize_keypoints(T(b["xy"])[None], hw),
                           T(a["valid"], torch.bool)[None], T(b["valid"], torch.bool)[None])
    block = np.ix_(a["valid"], b["valid"])
    assert lt.shape == (1, KP, KP)
    np.testing.assert_allclose(lt[0].numpy()[block], la[block],
                               atol=2e-3 * np.abs(la[block]).max())
    np.testing.assert_allclose(t0[0].numpy(), m0, atol=1e-4)
    np.testing.assert_allclose(t1[0].numpy(), m1, atol=1e-4)
    # the match extraction of the JAX assignment: identical
    ref = jlg.extract_matches(jnp.asarray(la), jnp.asarray(a["valid"]),
                              jnp.asarray(b["valid"]), threshold=0.01)
    got = tlg.extract_matches(T(la), T(a["valid"], torch.bool), T(b["valid"], torch.bool),
                              threshold=0.01)
    np.testing.assert_array_equal(got.idx2.numpy(), np.asarray(ref.idx2))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score), rtol=4e-7)  # exp: 1 ulp
    assert int(got.mask.sum()) >= 10


def test_extract_matches_identical_with_ties():
    """Mutual argmax with ties and padded rows and columns: the lower index
    wins, as in jnp.argmax."""
    rng = np.random.default_rng(1)
    la = np.log(np.round(rng.random((2, 30, 25)) * 4) / 4 + 1e-9).astype(np.float32)
    v0 = rng.random((2, 30)) > 0.2
    v1 = rng.random((2, 25)) > 0.2
    got = tlg.extract_matches(T(la), T(v0, torch.bool), T(v1, torch.bool), 0.1)
    for b in range(2):
        ref = jlg.extract_matches(jnp.asarray(la[b]), jnp.asarray(v0[b]), jnp.asarray(v1[b]),
                                  0.1)
        np.testing.assert_array_equal(got.idx2[b].numpy(), np.asarray(ref.idx2))
        np.testing.assert_array_equal(got.mask[b].numpy(), np.asarray(ref.mask))


# -- match_pairs_batched with the JAX draws ---------------------------------------


PAIRS = [(0, 1), (1, 2), (0, 2)]


def _jax_draws(jm, feats, pairs, key, chunk, hw):
    """The RANSAC samples the JAX match_pairs_batched draws for each chunk:
    per pair, sample_indices of its key over the mask of each matcher's
    matches (with the nn fallback both use the pair's key)."""
    H = jm.match_config.ransac_hypotheses
    nn_match = jax.jit(lambda a, b: jax_match_descriptors(a.desc, b.desc, a.valid, b.valid,
                                                          ratio=jm.config.nn_ratio).mask)
    lg_apply = jax.jit(jm.lg.apply)
    out = []
    for c0 in range(0, len(pairs), chunk):
        keys = jax.random.split(jax.random.fold_in(key, c0), chunk)
        d = {"nn": [], "lightglue": []}
        for r, (i, j) in enumerate(pairs[c0: c0 + chunk]):
            fi, fj = feats[i], feats[j]
            d["nn"].append(np.asarray(jax_sample_indices(
                keys[r], nn_match(fi, fj).astype(jnp.float32), H, 8)))
            if jm.matcher_kind == "lightglue":
                la, _, _ = lg_apply(jm._lg_params, fi.desc, fj.desc,
                                    jlg.normalize_keypoints(fi.xy, hw),
                                    jlg.normalize_keypoints(fj.xy, hw), fi.valid, fj.valid)
                lm = jlg.extract_matches(la, fi.valid, fj.valid,
                                         jm.config.lightglue_match_threshold)
                d["lightglue"].append(np.asarray(jax_sample_indices(
                    keys[r], lm.mask.astype(jnp.float32), H, 8)))
        out.append({k: torch.from_numpy(np.stack(v)).long() for k, v in d.items() if v})
    return out


@pytest.mark.parametrize("kind", ["nn", "lightglue"])
def test_match_pairs_batched_with_the_jax_draws(matchers, gray, kind):
    """The JAX features through both match_pairs_batched (2 chunks), the
    port given the JAX draws: nn identical inliers and F within 1e-3 of its
    norm; LightGlue, whose matches come out of the network's float
    differences, the same inlier counts within 2 and 95% of the inliers
    shared."""
    jm0, _ = matchers
    cfg = dict(matcher=kind, max_keypoints=KP)
    jm = JaxMatcher(JaxNeuralConfig(**cfg))
    jm._sp_params, jm._lg_params = jm0._sp_params, jm0._lg_params
    tm = NeuralMatcher(NeuralConfig(**cfg), device="cpu")
    hw = (128, 160)
    feats = [jm.extract(g) for g in gray]
    key = jax.random.PRNGKey(3)
    ref = jm.match_pairs_batched(feats, PAIRS, key, chunk=2, hw=hw)
    draws = _jax_draws(jm, feats, PAIRS, key, 2, hw)
    tfeats = [tsp.NeuralFeatures(**{k: T(np.asarray(getattr(f, k)),
                                     torch.bool if k == "valid" else torch.float32)
                                    for k in ("xy", "score", "desc", "valid")})
              for f in feats]
    got = tm.match_pairs_batched(tfeats, PAIRS, None, chunk=2, hw=hw, sample_indices=draws)
    for (i, j, idx1, idx2, F, n_inl, n_raw), r in zip(got, ref):
        assert (i, j) == (r[0], r[1])
        if kind == "nn":
            assert n_raw == r[6] and n_inl == r[5]
            np.testing.assert_array_equal(idx1, r[2])
            np.testing.assert_array_equal(idx2, r[3])
            Fs = F * np.sign((F * r[4]).sum())
            np.testing.assert_allclose(Fs, r[4], atol=1e-3 * np.linalg.norm(r[4]))
        else:
            assert abs(n_inl - r[5]) <= 2 and abs(n_raw - r[6]) <= 2
            shared = set(zip(idx1.tolist(), idx2.tolist())) & set(zip(r[2].tolist(),
                                                                      r[3].tolist()))
            assert len(shared) >= 0.95 * r[5]
        assert n_inl >= 20


# -- end to end ------------------------------------------------------------------


def _neural_config(cls, kind):
    """tests/test_neural_bundled.py::test_neural_sfm_end_to_end's settings."""
    cfg = cls()
    return cfg.replace(
        neural=dataclasses.replace(cfg.neural, max_keypoints=512, detection_threshold=2e-4,
                                   matcher=kind),
        match=dataclasses.replace(cfg.match, min_matches=12, ransac_hypotheses=512),
        sfm=dataclasses.replace(cfg.sfm, pnp_hypotheses=512, min_matches_init=30),
    )


@pytest.mark.parametrize("kind", ["nn", "lightglue"])
def test_neural_sfm_end_to_end(kind):
    """Neural SfM on the 5 rendered views of
    tests/test_neural_bundled.py::test_neural_sfm_end_to_end, held to that
    test's bounds (which the JAX pipeline passes there): every camera, more
    than 50 points, under 3 px."""
    scene = render_views(n_views=5, image_size=(128, 160))
    pipe = SfMPipeline(neural_mode=True, config=_neural_config(ReconstructionConfig, kind),
                       device="cpu")
    pts, cols, poses = pipe.reconstruct(
        image_set=image_set_from_arrays(scene["images"], Camera.from_matrix(scene["K"])))
    assert len(poses) == 5 and len(pts) > 50
    assert pipe._mean_reproj_error() < 3.0
    assert pipe.matcher.matcher_kind == kind and pipe.features_stacked is None
    assert cols.shape == pts.shape and np.isfinite(pts).all()
