"""The port's SuperPoint and LightGlue against their plain reference
(benchmark/reference/superpoint_lightglue.py) on the CPU, at full width (256-d
descriptors, 9 LightGlue layers of 4 heads) and a small size (two images
of 120x160, 256 keypoint slots), with seeded random weights (flax_init_)
and with the bundled checkpoints; the reference in bfloat16 against the
same tolerances; and a 5-view neural SfM scene with its spans, counters
and the log-assignment the matcher keeps for named pairs.

The reference sums in its own order (its own bilinear gather, x @ kernel
for nn.Linear's x @ W^T), so the networks are held to tolerances stated
here; the selections (NMS, top-k, mutual argmax) to equality.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import NeuralConfig, ReconstructionConfig
from recon3d_tpu_torch.io.dataset import image_set_from_arrays
from benchmark.reference import superpoint_lightglue as reference
from recon3d_tpu_torch.neural.lightglue import (
    LightGlueNet,
    extract_matches,
    log_double_softmax,
    normalize_keypoints,
)
from recon3d_tpu_torch.neural.matcher import (
    BUNDLED_LIGHTGLUE,
    BUNDLED_SUPERPOINT,
    NeuralMatcher,
)
from recon3d_tpu_torch.neural.superpoint import (
    SuperPointNet,
    detect_keypoints,
    scores_from_logits,
)
from recon3d_tpu_torch.neural.weights import flax_init_, save_params_npz
from recon3d_tpu_torch.runtime.profiling import finished
from recon3d_tpu_torch.sfm.pipeline import SfMPipeline
from tests.render import render_views

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
KP = 256
THRESHOLD = 0.0005
# float32 against float32 in another summation order
PROB_TOL = 1e-5          # detector probability, absolute
DESC_TOL = 1e-5          # descriptor component, absolute
XY_TOL = 1e-4            # refined keypoint, pixels
LOG_ASSIGN_TOL = 2e-3    # log-assignment entries reach -200: ~1e-5 relative
MATCHABILITY_TOL = 1e-4  # a sigmoid of the ninth layer's features


@pytest.fixture(scope="module")
def gray():
    scene = render_views(n_views=2, image_size=(120, 160), arc_step=0.12)
    return scene["images"] @ np.array([0.299, 0.587, 0.114], np.float32)


@pytest.fixture(scope="module", params=["seeded", "bundled"])
def weights(request, tmp_path_factory):
    """(SuperPoint .npz, LightGlue .npz): seeded random weights drawn by
    flax_init_ and written as checkpoints, or the bundled ones."""
    if request.param == "bundled":
        return BUNDLED_SUPERPOINT, BUNDLED_LIGHTGLUE
    d = tmp_path_factory.mktemp("weights")
    gen = torch.Generator().manual_seed(20)
    paths = []
    for name, module in (("superpoint", SuperPointNet()), ("lightglue", LightGlueNet())):
        flax_init_(module, gen)
        save_params_npz(module, d / f"{name}.npz")
        paths.append(d / f"{name}.npz")
    return tuple(paths)


@pytest.fixture(scope="module")
def matcher(weights):
    m = NeuralMatcher(NeuralConfig(matcher="lightglue", max_keypoints=KP,
                                   superpoint_weights=str(weights[0]),
                                   lightglue_weights=str(weights[1])), device="cpu")
    m._ensure_params()
    return m


@pytest.fixture(scope="module")
def params(weights):
    return reference.load_params(weights[0]), reference.load_params(weights[1])


def _port_superpoint(m, img):
    with torch.no_grad():
        logits, desc = m.sp(torch.from_numpy(img)[None, ..., None])
    prob = scores_from_logits(logits)[0]
    feats = detect_keypoints(prob, desc[0], KP, THRESHOLD, 4)
    return prob, feats


def _superpoint_errors(port_prob, feats, ref):
    v = feats.valid
    return {"prob": float((port_prob - ref["prob"].float()).abs().max()),
            "desc": float((feats.desc[v] - ref["desc"].float()[v]).abs().max()),
            "xy": float((feats.xy[v] - ref["xy"][v]).abs().max())}


@pytest.mark.parametrize("view", [0, 1])
def test_superpoint_matches_the_reference(matcher, params, gray, view):
    """Probabilities over the whole map, the selected keypoints (the same
    slots, the same validity), their refined positions and descriptors."""
    prob, feats = _port_superpoint(matcher, gray[view])
    ref = reference.superpoint(params[0], torch.from_numpy(gray[view]), KP, THRESHOLD, 4)
    assert torch.equal(feats.valid, ref["valid"]) and int(feats.valid.sum()) > 30
    assert float((feats.score - ref["score"]).abs().max()) <= PROB_TOL
    err = _superpoint_errors(prob, feats, ref)
    assert err["prob"] <= PROB_TOL and err["desc"] <= DESC_TOL and err["xy"] <= XY_TOL, err


def _pair(matcher, gray):
    return [matcher.extract(g) for g in gray]


def test_lightglue_matches_the_reference(matcher, params, gray):
    """The log-assignment over the valid rows and columns and the dustbins,
    matchability and the mutual-argmax matches, over all 9 layers."""
    f0, f1 = _pair(matcher, gray)
    hw = gray.shape[1:]
    with torch.no_grad():
        z, m0, m1 = matcher.lg.scores(f0.desc[None], f1.desc[None],
                                      normalize_keypoints(f0.xy[None], hw),
                                      normalize_keypoints(f1.xy[None], hw),
                                      f0.valid[None], f1.valid[None])
        la = log_double_softmax(z, m0, m1)[0]
        _, s0, s1 = matcher.lg(f0.desc[None], f1.desc[None], normalize_keypoints(f0.xy[None], hw),
                               normalize_keypoints(f1.xy[None], hw), f0.valid[None],
                               f1.valid[None])
    assert matcher.lg.num_layers == 9
    ref = reference.lightglue(params[1], f0.desc, f1.desc, f0.xy, f1.xy, f0.valid, f1.valid, hw)
    v0, v1 = f0.valid, f1.valid
    assert float((la - ref[:-1, :-1])[v0][:, v1].abs().max()) <= LOG_ASSIGN_TOL
    # the dustbins are logsigmoid(-m): matchability is 1 - their exp
    assert float((s0[0] + torch.expm1(ref[:-1, -1]))[v0].abs().max()) <= MATCHABILITY_TOL
    assert float((s1[0] + torch.expm1(ref[-1, :-1]))[v1].abs().max()) <= MATCHABILITY_TOL
    ours = extract_matches(la, v0, v1, threshold=0.01)
    idx2, _ = reference.mutual_matches(ref, v0, v1, 0.01)
    assert torch.equal(ours.idx2, idx2)


def test_the_reference_in_bfloat16_breaks_the_tolerances(matcher, params, gray):
    """The reference computed in bfloat16 against the port: each network
    number this file holds the port to is broken."""
    prob, feats = _port_superpoint(matcher, gray[0])
    ref = reference.superpoint(params[0], torch.from_numpy(gray[0]), KP, THRESHOLD, 4,
                               dtype=torch.bfloat16)
    err = _superpoint_errors(prob, feats, dict(ref, desc=reference.sample_descriptors(
        ref["desc_map"].float(), feats.xy)))
    assert err["prob"] > PROB_TOL and err["desc"] > DESC_TOL, err
    f0, f1 = _pair(matcher, gray)
    hw = gray.shape[1:]
    fp32 = reference.lightglue(params[1], f0.desc, f1.desc, f0.xy, f1.xy, f0.valid, f1.valid, hw)
    bf16 = reference.lightglue(params[1], f0.desc, f1.desc, f0.xy, f1.xy, f0.valid, f1.valid, hw,
                               dtype=torch.bfloat16)
    rows, cols = torch.cat([f0.valid, torch.tensor([True])]), torch.cat([f1.valid,
                                                                         torch.tensor([True])])
    assert float((fp32 - bf16.float())[rows][:, cols].abs().max()) > LOG_ASSIGN_TOL


def test_the_reference_imports_nothing_of_the_port_and_the_benchmark_holds_a_copy():
    """The benchmark's file is the one copy: the port ships none."""
    assert not (ROOT / "recon3d_tpu_torch" / "neural" / "reference.py").exists()
    path = str(ROOT / "benchmark" / "reference" / "superpoint_lightglue.py")
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('ref', {path!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "top = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(top & {'recon3d_tpu_torch', 'recon3d_tpu', 'jax', 'jaxlib', 'flax'}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       cwd="/")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def _neural_config():
    """tests/test_torch_neural.py's end-to-end settings, with LightGlue."""
    cfg = ReconstructionConfig()
    return cfg.replace(
        neural=dataclasses.replace(cfg.neural, max_keypoints=512, detection_threshold=2e-4,
                                   matcher="lightglue"),
        match=dataclasses.replace(cfg.match, min_matches=12, ransac_hypotheses=512),
        sfm=dataclasses.replace(cfg.sfm, pnp_hypotheses=512, min_matches_init=30),
    )


@pytest.fixture(scope="module")
def neural_scene():
    scene = render_views(n_views=5, image_size=(128, 160))
    pipe = SfMPipeline(neural_mode=True, config=_neural_config(), device="cpu")
    named = [(0, 1), (1, 3)]
    pipe.matcher.keep_assignment = named
    pipe.reconstruct(image_set=image_set_from_arrays(scene["images"],
                                                     Camera.from_matrix(scene["K"])))
    root = [e for e in finished() if e["name"] == "sfm.reconstruct"][-1]
    return pipe, root, named


def test_a_neural_scene_opens_the_spans_and_counts_every_pair(neural_scene):
    pipe, root, _ = neural_scene
    pairs = pipe.stats["num_candidate_pairs"]
    chunks = -(-pairs // 8)
    assert pipe.matcher.matcher_kind == "lightglue" and len(pipe.poses) == 5
    assert root["count"]["neural.superpoint"] == 5 and root["counters"]["neural.images"] == 5
    assert root["count"]["neural.match"] == 1
    assert root["count"]["neural.lightglue"] == chunks == root["count"]["neural.verify"]
    assert root["counters"]["neural.lightglue_pairs"] == pairs == 10
    assert root["counters"]["neural.keypoints"] == sum(pipe.stats["features_per_image"])
    assert 0 <= root["counters"].get("neural.nn_kept_pairs", 0) <= pairs
    # matching ends on its host read, inside the stage
    assert root["seconds"]["neural.match"] <= root["seconds"]["sfm.match"]
    assert root["seconds"]["neural.lightglue"] <= root["seconds"]["neural.match"]
    spans = root["spans"]
    match = next(i for i, s in enumerate(spans) if s["name"] == "neural.match")
    assert any(s["name"] == "host.pull" and s["parent"] == match for s in spans)


def test_the_kept_log_assignment_is_the_timed_networks(neural_scene):
    """The pairs the caller named, and only those, keep their
    (N + 1, N + 1) log-assignment: the reference's on the scene's own
    features, dustbins included."""
    pipe, _, named = neural_scene
    m = pipe.matcher
    assert sorted(m.kept_assignment) == named
    params = reference.load_params(BUNDLED_LIGHTGLUE)
    hw = pipe.image_set.gray.shape[1:3]
    for i, j in named:
        f0, f1 = pipe.features[i], pipe.features[j]
        got = m.kept_assignment[(i, j)]
        assert got.shape == (513, 513)
        ref = reference.lightglue(params, f0.desc, f1.desc, f0.xy, f1.xy, f0.valid, f1.valid, hw)
        rows = torch.cat([f0.valid, torch.tensor([True])])
        cols = torch.cat([f1.valid, torch.tensor([True])])
        assert float((got - ref)[rows][:, cols].abs().max()) <= LOG_ASSIGN_TOL


def test_the_kept_matches_are_lightglues_before_the_fallback(neural_scene):
    """The named pairs keep LightGlue's own matches, whichever verdict won:
    the mutual argmax of their kept log-assignment, and the reference's
    matches on its own log-assignment."""
    pipe, _, named = neural_scene
    m = pipe.matcher
    assert sorted(m.kept_matches) == named
    params = reference.load_params(BUNDLED_LIGHTGLUE)
    hw = pipe.image_set.gray.shape[1:3]
    thr = pipe.config.neural.lightglue_match_threshold
    for i, j in named:
        f0, f1 = pipe.features[i], pipe.features[j]
        got = m.kept_matches[(i, j)]
        own = extract_matches(m.kept_assignment[(i, j)][:-1, :-1], f0.valid, f1.valid, thr)
        assert torch.equal(got, own.idx2) and int((got >= 0).sum()) > 0
        ref = reference.lightglue(params, f0.desc, f1.desc, f0.xy, f1.xy, f0.valid, f1.valid, hw)
        idx2, _ = reference.mutual_matches(ref, f0.valid, f1.valid, thr)
        assert torch.equal(got, idx2)


def test_nothing_is_kept_unless_pairs_are_named():
    scene = render_views(n_views=3, image_size=(96, 128), arc_step=0.1)
    gray = scene["images"] @ np.array([0.299, 0.587, 0.114], np.float32)
    m = NeuralMatcher(NeuralConfig(matcher="lightglue", max_keypoints=128), device="cpu")
    feats = [m.extract(g) for g in gray]
    m.match_pairs_batched(feats, [(0, 1), (0, 2), (1, 2)], torch.Generator().manual_seed(0),
                          hw=gray.shape[1:])
    assert m.kept_assignment == {} and m.kept_matches == {}
    m.keep_assignment = [(0, 2)]
    m.match_pairs_batched(feats, [(0, 1), (0, 2), (1, 2)], torch.Generator().manual_seed(0),
                          hw=gray.shape[1:])
    assert list(m.kept_assignment) == [(0, 2)] and m.kept_assignment[(0, 2)].shape == (129, 129)
    assert list(m.kept_matches) == [(0, 2)] and m.kept_matches[(0, 2)].shape == (128,)
