"""Stages 1-3 of the port's SfMPipeline (load, extract_features,
match_image_pairs, with the long-span rematch and the match graph) against
the JAX pipeline on the same rendered views, on the CPU.

The RANSAC draws of the two packages cannot be made equal at this level,
so the comparison is by outcome: the same pairs kept, inlier counts within
10%, the same keypoints, and the port's inliers under the scene's true
epipolar geometry.
"""

import dataclasses

import numpy as np
import pytest
import torch

from recon3d_tpu.camera import Camera as JaxCamera
from recon3d_tpu.config import ReconstructionConfig as JaxConfig
from recon3d_tpu.io.dataset import image_set_from_arrays as jax_image_set
from recon3d_tpu.sfm import pipeline as jpipe
from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import ReconstructionConfig
from recon3d_tpu_torch.io.dataset import image_set_from_arrays
from recon3d_tpu_torch.sfm import pipeline as tpipe
from tests.render import render_views
from tests.torch_scene import match_graph_levels, sampson_np, true_fundamental

# The test workers share the machine's cores: PyTorch's default of one
# thread per core in every worker makes them wait on one another.
torch.set_num_threads(2)


def _config(cls, match_window):
    cfg = cls()
    return cfg.replace(
        sift=dataclasses.replace(cfg.sift, max_features=1024),
        match=dataclasses.replace(cfg.match, ransac_hypotheses=256),
        sfm=dataclasses.replace(cfg.sfm, match_window=match_window),
    )


def _run_both(n_views, match_window):
    scene = render_views(n_views=n_views, image_size=(120, 160), arc_step=0.12)
    ref = jpipe.SfMPipeline(config=_config(JaxConfig, match_window))
    ref.set_image_set(jax_image_set(scene["images"], JaxCamera.from_matrix(scene["K"])))
    port = tpipe.SfMPipeline(config=_config(ReconstructionConfig, match_window), device="cpu")
    port.set_image_set(image_set_from_arrays(scene["images"], Camera.from_matrix(scene["K"])))
    for pipe in (ref, port):
        pipe.extract_features()
        pipe.match_image_pairs()
    return scene, ref, port


@pytest.fixture(scope="module")
def eight_views():
    return _run_both(8, 8)


@pytest.fixture(scope="module")
def long_span():
    return _run_both(10, 2)


def test_features_equal_the_jax_pipelines(eight_views):
    _, ref, port = eight_views
    assert port.stats["features_per_image"] == ref.stats["features_per_image"]
    assert min(port.stats["features_per_image"]) > 60
    for a, b, n in zip(port.kp_xy, ref.kp_xy, port.stats["features_per_image"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a[:n], b[:n], atol=0.05)      # same slots, same order
    assert len(port.features) == 8 and port.features[3].desc.shape == (a.shape[0], 128)
    assert set(port.stats["extract_detail_s"]) == set(ref.stats["extract_detail_s"])
    assert all(len(k) == len(port.kp_xy[0]) and (k == -1).all() for k in port.kp_to_point)


def test_same_pairs_kept_with_inlier_counts_within_a_tenth(eight_views):
    _, ref, port = eight_views
    assert set(port.matches) == set(ref.matches) and len(port.matches) >= 20
    assert port.stats["num_pairs"] == ref.stats["num_pairs"] == len(port.matches)
    for pair, m in port.matches.items():
        r = ref.matches[pair]
        assert abs(m["n"] - r["n"]) <= max(2, 0.1 * r["n"]), pair
        assert m["n"] == len(m["idx1"]) == len(m["idx2"]) >= port.config.match.min_matches
        # mostly the very same correspondences
        same = set(zip(m["idx1"].tolist(), m["idx2"].tolist())) & set(
            zip(r["idx1"].tolist(), r["idx2"].tolist()))
        assert len(same) >= 0.8 * r["n"], pair


def test_inliers_lie_on_the_true_epipolar_geometry(eight_views):
    scene, ref, port = eight_views
    got = match_graph_levels(port.matches, port.kp_xy, scene, len(port._components(8)))
    want = match_graph_levels(ref.matches, ref.kp_xy, scene, len(ref._components(8)))
    assert got["adjacent_kept"] == got["adjacent_total"] == 7 and got["components"] == 1
    assert got["median_sampson_px"] < 1.0 and got["share_under_threshold"] >= 0.95
    assert got["median_sampson_px"] <= 1.1 * want["median_sampson_px"]
    assert got["share_under_threshold"] >= want["share_under_threshold"] - 0.01
    # each pair's own F explains its inliers, as the true one does
    for (i, j), m in port.matches.items():
        x1, x2 = port.kp_xy[i][m["idx1"]], port.kp_xy[j][m["idx2"]]
        assert sampson_np(m["F"].astype(np.float64), x1, x2).max() < 2.0
        F_true = true_fundamental(scene["K"], scene["Rs"][i], scene["ts"][i],
                                  scene["Rs"][j], scene["ts"][j])
        assert np.median(sampson_np(F_true, x1, x2)) < 1.0


def test_kp_links_mirror_the_matches(eight_views):
    _, ref, port = eight_views
    m = port.matches[(0, 1)]
    ka, kb = int(m["idx1"][0]), int(m["idx2"][0])
    assert (1, kb) in port._kp_links[0][ka] and (0, ka) in port._kp_links[1][kb]
    n_links = sum(len(v) for d in port._kp_links.values() for v in d.values())
    assert n_links == 2 * sum(m["n"] for m in port.matches.values())


def test_long_span_rematch_matches_the_jax_pipeline(long_span):
    """match_window=2: the failed probe pairs of span >= 4 go through the 2x
    rematch, where both packages reject them as explained by one
    homography (the scene is made of planes)."""
    _, ref, port = long_span
    assert set(port.matches) == set(ref.matches)
    assert {p for p, m in port.matches.items() if m.get("aux")} == {
        p for p, m in ref.matches.items() if m.get("aux")}
    assert port.stats["rematch_attempted"] >= 3
    assert (port.stats["rematch_recovered"] + port.stats["rematch_rejected"]
            <= port.stats["rematch_attempted"])
    assert port.stats["rematch_rejected"] >= 1
    assert port.stats["num_pairs"] == ref.stats["num_pairs"]
    for g in range(10):           # recovered keypoints append to both tables alike
        assert len(port.kp_xy[g]) == len(port.kp_to_point[g]) == len(ref.kp_xy[g])


def test_bridging_reconnects_a_fragmented_graph(eight_views):
    _, _, port = eight_views
    saved = dict(port.matches)
    try:
        for pair in list(port.matches):
            if (pair[0] < 4) != (pair[1] < 4):
                del port.matches[pair]                     # cut between views 3 and 4
        comps = port._components(8)
        assert [sorted(c) for c in comps] in ([[0, 1, 2, 3], [4, 5, 6, 7]],
                                              [[4, 5, 6, 7], [0, 1, 2, 3]])
        port._bridge_components(8)
        assert len(port._components(8)) == 1
        (bridge,) = set(port.matches) - {p for p in saved if (p[0] < 4) == (p[1] < 4)}
        m = port.matches[bridge]
        assert m["n"] == len(m["idx1"]) >= port.config.match.min_matches
        assert m["F"].shape == (3, 3) and (m["idx2"] >= 0).all()
    finally:
        port.matches = saved


@pytest.mark.parametrize("n,window,loop", [(8, 8, True), (50, 8, True), (12, 2, True),
                                           (300, 8, True), (20, 4, False), (5, 2, True)])
def test_candidate_pairs_equal_the_jax_pipelines(n, window, loop):
    def pairs(mod, cls, **kw):
        cfg = cls()
        cfg = cfg.replace(sfm=dataclasses.replace(cfg.sfm, match_window=window,
                                                  loop_closure=loop))
        return mod.SfMPipeline(config=cfg, **kw)._candidate_pairs(n)

    got = pairs(tpipe, ReconstructionConfig, device="cpu")
    assert got == pairs(jpipe, JaxConfig)
    if (n, window) == (50, 8):
        assert len(got) == 435          # the north-star scene's candidate pairs


def test_pad_pow2_equals_the_jax_pipelines():
    for n in (0, 1, 63, 64, 65, 256, 257, 1025, 5000, 20000):
        for kw in ({}, {"lo": 64}, {"lo": 64, "factor": 2, "hi": 1024}):
            assert tpipe._pad_pow2(n, **kw) == jpipe._pad_pow2(n, **kw)


def test_load_images_then_extract(tmp_path):
    from PIL import Image

    scene = render_views(n_views=3, image_size=(64, 80), arc_step=0.1)
    for i, img in enumerate(scene["images"]):
        Image.fromarray((img * 255).astype(np.uint8)).save(tmp_path / f"v{i}.png")
    pipe = tpipe.SfMPipeline(config=_config(ReconstructionConfig, 8), device="cpu")
    iset = pipe.load_images(str(tmp_path), max_images=2)
    assert iset.gray.shape == (2, 64, 80) and pipe.camera is iset.camera
    pipe.extract_features()
    assert len(pipe.kp_xy) == 2 and pipe.features_stacked.desc.device.type == "cpu"
    pipe.extract_features()                      # a second call starts afresh
    assert len(pipe.kp_xy) == len(pipe.kp_to_point) == 2


def test_default_device_is_cuda_and_later_stages_name_the_roadmap():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tpipe.SfMPipeline()
    pipe = tpipe.SfMPipeline(device="cpu")
    assert pipe.device.type == "cpu" and pipe.config == ReconstructionConfig()
    assert tpipe.SfMPipeline(fast_mode=True, device="cpu").config.sift.max_features == 3000
    # what is still to be ported names its ROADMAP item (save_colmap, global
    # SfM and the neural front end are ported: tests/test_torch_cli.py,
    # test_torch_global_sfm.py and test_torch_neural.py run them)
    with pytest.raises(ValueError, match="need image_dir or image_set"):
        pipe.reconstruct_global()
    # the back end's stages exist and do nothing on an empty pipeline
    assert pipe.find_best_initial_pair() is None and pipe.find_next_image() is None
    assert pipe.register_image(0) is False and pipe.bundle_adjustment_full() is None
    assert pipe._rescue_unregistered() == 0
    neural = tpipe.SfMPipeline(neural_mode=True, device="cpu")
    assert neural.matcher is neural.extractor and neural.matcher.matcher_kind == "nn"
    with pytest.raises(NotImplementedError, match="item 12"):
        tpipe.SfMPipeline(mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        pipe.reconstruct()


def test_reconstruct_runs_the_front_end_then_stops_at_the_back_end():
    """Three views of 64x80 match too thinly for an initial pair: the front
    end runs, and the back end stops at its first stage with the JAX
    pipeline's error."""
    scene = render_views(n_views=3, image_size=(64, 80), arc_step=0.1)
    pipe = tpipe.SfMPipeline(config=_config(ReconstructionConfig, 8), device="cpu")
    iset = image_set_from_arrays(scene["images"], Camera.from_matrix(scene["K"]))
    with pytest.raises(RuntimeError, match="no valid initial pair found"):
        pipe.reconstruct(image_set=iset)
    assert pipe.stats["num_candidate_pairs"] == 3 and "match_time" in pipe.stats
    assert pipe.registered == set() and len(pipe.points3d) == 0


def test_rematch_recovers_pairs_as_the_jax_pipeline_does(long_span, monkeypatch):
    """With the homography gate held open in both packages (the rendered
    scene is made of planes, so the gate rejects every probe pair), the
    pairs that pass the essential-matrix gate are recovered as `aux` edges
    whose keypoints are appended, compacted, to the per-image tables."""
    from collections import namedtuple

    from recon3d_tpu.ops import estimation as jest

    scene, ref, port = long_span
    no_plane = namedtuple("HomographyResult", "H inliers num_inliers")(None, None, 0)
    monkeypatch.setattr(jest, "estimate_homography_ransac", lambda *a, **k: no_plane)
    monkeypatch.setattr(tpipe, "estimate_homography_ransac", lambda *a, **k: no_plane)
    pairs = port._candidate_pairs(10)
    before = [len(k) for k in port.kp_xy]
    saved = [(p.matches.copy(), list(p.kp_xy), list(p.kp_to_point)) for p in (ref, port)]
    try:
        n_ref, n_port = ref._rematch_long_span(pairs), port._rematch_long_span(pairs)
        aux = {p for p, m in port.matches.items() if m.get("aux")}
        assert n_port == n_ref == len(aux) >= 1
        assert aux == {p for p, m in ref.matches.items() if m.get("aux")}
        assert port.stats["rematch_recovered"] == n_port
        for (i, j) in aux:
            m, r = port.matches[(i, j)], ref.matches[(i, j)]
            assert abs(m["n"] - r["n"]) <= max(2, 0.1 * r["n"])
            # appended keypoints: behind the load-resolution table, all valid
            assert m["idx1"].min() >= before[i] and m["idx2"].min() >= before[j]
            assert m["idx1"].max() < len(port.kp_xy[i]) == len(port.kp_to_point[i])
            assert len(port.kp_xy[i]) == len(ref.kp_xy[i])
            x1, x2 = port.kp_xy[i][m["idx1"]], port.kp_xy[j][m["idx2"]]
            # in load-resolution pixels, under the conjugated F and the true one
            assert np.median(sampson_np(m["F"].astype(np.float64), x1, x2)) < 1.0
            F_true = true_fundamental(scene["K"], scene["Rs"][i], scene["ts"][i],
                                      scene["Rs"][j], scene["ts"][j])
            assert np.median(sampson_np(F_true, x1, x2)) < 1.5
        port._build_kp_links()
        assert all(b not in {q for q, _ in port._kp_links.get(a, {}).get(k, [])}
                   for (a, b) in aux for k in port.matches[(a, b)]["idx1"].tolist())
    finally:
        for p, (matches, kp_xy, kp_to_point) in zip((ref, port), saved):
            p.matches, p.kp_xy, p.kp_to_point = matches, kp_xy, kp_to_point
