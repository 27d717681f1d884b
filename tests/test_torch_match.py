"""Descriptor matching of the PyTorch port against the JAX package (CPU),
and the batched match stage against the per-pair one.

Indices and masks are compared exactly. On inputs without ties nothing
depends on how a backend breaks them; one case with duplicate descriptors
and padded columns pins the rule (the lower index wins, invalid slots
never).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from recon3d_tpu.features import frontend as jfront
from recon3d_tpu.ops import match as jmatch
from recon3d_tpu.ops import sift as jsift
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.config import MatchConfig, SiftConfig
from recon3d_tpu_torch.features.frontend import (
    FeatureExtractor,
    FeatureMatcher,
    feature_slice,
    match_pairs_batched,
)
from recon3d_tpu_torch.ops import match as tmatch
from tests.render import render_views

# The test workers share the machine's cores: PyTorch's default of one
# thread per core in every worker makes them wait on one another.
torch.set_num_threads(2)


def _random_descs(rng, n, d=32):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _descriptor_sets(rng):
    """300 x 350 descriptors: noisy copies of half of set 1 + distractors,
    the last slots of each set invalid."""
    d1 = _random_descs(rng, 300)
    d2 = np.concatenate([
        d1[:150] + rng.normal(scale=0.05, size=(150, 32)).astype(np.float32),
        _random_descs(rng, 200),
    ])
    d2 = d2 / np.linalg.norm(d2, axis=1, keepdims=True)
    v1 = np.ones(300, np.float32)
    v1[290:] = 0
    v2 = np.ones(350, np.float32)
    v2[340:] = 0
    return d1, d2, v1, v2


def _assert_same_matches(got, ref, dist_atol=1e-5):
    mask = np.asarray(ref.mask)
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    np.testing.assert_array_equal(got.idx2.numpy(), np.asarray(ref.idx2))
    np.testing.assert_array_equal(got.idx1.numpy(), np.asarray(ref.idx1))
    np.testing.assert_allclose(got.distance.numpy()[mask], np.asarray(ref.distance)[mask],
                               rtol=1e-4, atol=dist_atol)


@pytest.mark.parametrize("ratio,cross_check,block", [(0.75, True, 64), (0.9, False, 128),
                                                     (0.8, True, 512)])
def test_match_descriptors_and_streaming_match_jax(rng, ratio, cross_check, block):
    arrays = _descriptor_sets(rng)
    jargs = tuple(map(jnp.asarray, arrays))
    targs = tuple(map(torch.from_numpy, arrays))
    ref = jmatch.match_descriptors(*jargs, ratio=ratio, cross_check=cross_check)
    ref_s = jmatch.match_descriptors_streaming(*jargs, ratio=ratio, cross_check=cross_check,
                                               block=block)
    got = tmatch.match_descriptors(*targs, ratio=ratio, cross_check=cross_check)
    got_s = tmatch.match_descriptors_streaming(*targs, ratio=ratio, cross_check=cross_check,
                                               block=block)
    assert int(got.num_matches) > 100
    _assert_same_matches(got, ref)
    _assert_same_matches(got_s, ref_s)
    _assert_same_matches(got_s, got)


def test_duplicates_and_padded_columns_pin_the_first_index_rule():
    """Rows 2 and 5 of set 1 are one descriptor, both nearest to column 4:
    the cross-check keeps the first (row 2). Row 1 is the same descriptor
    again but invalid, and columns 6-7 are invalid copies of column 4:
    neither may win. Columns 0 and 3 are one descriptor: row 0's two
    nearest tie, so its ratio test fails. (The distance of a descriptor to
    its exact copy is the root of a rounding error of the squared distance:
    1e-3 there.)"""
    rng = np.random.default_rng(7)
    d1 = _random_descs(rng, 8)
    d2 = _random_descs(rng, 8)
    d1[1] = d1[5] = d1[2]
    d2[4] = d1[2]
    d2[6] = d2[7] = d2[4]
    d2[3] = d2[0]
    d1[0] = d2[0]
    v1 = np.ones(8, np.float32)
    v1[1] = 0
    v2 = np.ones(8, np.float32)
    v2[6:] = 0
    jargs = tuple(map(jnp.asarray, (d1, d2, v1, v2)))
    targs = tuple(map(torch.from_numpy, (d1, d2, v1, v2)))
    for block in (2, 4, 1024):       # the duplicates in one block and in two
        ref = jmatch.match_descriptors_streaming(*jargs, ratio=0.9, block=block)
        got = tmatch.match_descriptors_streaming(*targs, ratio=0.9, block=block)
        _assert_same_matches(got, ref, dist_atol=1e-3)
        assert got.mask.tolist()[:6] == [False, False, True, got.mask.tolist()[3],
                                         got.mask.tolist()[4], False]
        assert int(got.idx2[2]) == 4 and int(got.idx2[5]) == -1
    _assert_same_matches(tmatch.match_descriptors(*targs, ratio=0.9),
                         jmatch.match_descriptors(*jargs, ratio=0.9), dist_atol=1e-3)
    _assert_same_matches(tmatch.match_descriptors(*targs, ratio=0.9), got, dist_atol=1e-3)


def test_all_columns_invalid_gives_no_match(rng):
    d1, d2, v1, _ = _descriptor_sets(rng)
    targs = tuple(map(torch.from_numpy, (d1, d2, v1, np.zeros(350, np.float32))))
    for m in (tmatch.match_descriptors(*targs), tmatch.match_descriptors_streaming(*targs)):
        assert not m.mask.any() and (m.idx2 == -1).all() and torch.isfinite(m.distance).all()


def test_matching_over_a_leading_pair_axis_equals_one_pair_at_a_time(rng):
    a = _descriptor_sets(rng)
    b = _descriptor_sets(rng)
    stacked = tuple(torch.from_numpy(np.stack(xy)) for xy in zip(a, b))
    both = tmatch.match_descriptors_streaming(*stacked, block=128)
    for p, arrays in enumerate((a, b)):
        one = tmatch.match_descriptors(*map(torch.from_numpy, arrays))
        np.testing.assert_array_equal(both.mask[p].numpy(), one.mask.numpy())
        np.testing.assert_array_equal(both.idx2[p].numpy(), one.idx2.numpy())


def test_gather_matched_points_matches_jax(rng):
    arrays = _descriptor_sets(rng)
    xy1 = rng.random((300, 2)).astype(np.float32) * 100
    xy2 = rng.random((350, 2)).astype(np.float32) * 100
    ref = jmatch.match_descriptors(*map(jnp.asarray, arrays))
    got = tmatch.match_descriptors(*map(torch.from_numpy, arrays))
    for g, r in zip(tmatch.gather_matched_points(torch.from_numpy(xy1), torch.from_numpy(xy2), got),
                    jmatch.gather_matched_points(jnp.asarray(xy1), jnp.asarray(xy2), ref)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ---------------------------------------------------------------------------
# The match stage on extracted features

SIFT = dataclasses.replace(SiftConfig(), max_features=1024)
MATCH = dataclasses.replace(MatchConfig(), ransac_hypotheses=256)
PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


@functools.lru_cache(maxsize=None)
def _scene_features():
    """Four views' features at the full single-phase capacity (about 1,150
    slots for some 80 keypoints), stacked, and the quantised images."""
    scene = render_views(n_views=4, image_size=(120, 160), arc_step=0.12)
    gray = scene["images"] @ np.array([0.299, 0.587, 0.114], np.float32)
    u8 = np.clip(gray * 255.0, 0, 255).astype(np.uint8).astype(np.float32) / 255.0
    ex = FeatureExtractor(SIFT, device="cpu")
    per_image = [ex.extract(im) for im in u8]
    return per_image[0].map(lambda *a: torch.stack(a), *per_image[1:]), u8


def _pair_set(idx1, idx2):
    return set(zip(np.asarray(idx1).tolist(), np.asarray(idx2).tolist()))


def test_match_pairs_batched_against_per_pair_geometric():
    """The batched stage (compaction, chunks of pairs, index translation)
    against FeatureMatcher on the uncompacted features: the same raw match
    counts, every inlier one of the pair's raw matches under its original
    keypoint indices, and inlier counts equal within the RANSAC draws."""
    feats, _ = _scene_features()
    assert feats.valid.shape[1] > 256 > int(feats.valid.sum(1).max())   # compaction bites
    tm = {}
    out = match_pairs_batched(feats, PAIRS, torch.Generator().manual_seed(0), MATCH,
                              chunk=4, timings=tm)        # two chunks: 4 + 2 pairs
    assert [(r[0], r[1]) for r in out] == PAIRS
    assert set(tm) == {"valid_fetch_s", "compact_s", "dispatch_s", "result_pull_s",
                       "translate_s"}
    matcher = FeatureMatcher(MATCH)
    gen = torch.Generator().manual_seed(1)
    for (i, j, idx1, idx2, F, n_inl, n_raw) in out:
        f1, f2 = feature_slice(feats, i), feature_slice(feats, j)
        raw = matcher.match(f1, f2)
        assert n_raw == int(raw.num_matches)
        raw_pairs = _pair_set(raw.idx1[raw.mask], raw.idx2[raw.mask])
        assert len(idx1) == n_inl and _pair_set(idx1, idx2) <= raw_pairs
        assert f1.valid[idx1].all() and f2.valid[idx2].all()
        m, F1, n1 = matcher.match_pair_geometric(f1, f2, gen)
        if n_raw >= MATCH.min_matches:
            assert abs(n1 - n_inl) <= max(2, 0.1 * n_inl)
            assert int(m.mask.sum()) == n1
            both = _pair_set(idx1, idx2) & _pair_set(m.idx1[m.mask], m.idx2[m.mask])
            assert len(both) >= 0.8 * n_inl
        else:
            assert n1 == 0 and not m.mask.any()
    assert sum(r[5] >= MATCH.min_matches for r in out) >= 3      # the adjacent pairs


def test_a_list_of_per_image_features_matches_like_the_stacked_batch():
    feats, _ = _scene_features()
    as_list = [feature_slice(feats, i) for i in range(4)]
    a = match_pairs_batched(feats, PAIRS[:3], torch.Generator().manual_seed(0), MATCH)
    b = match_pairs_batched(as_list, PAIRS[:3], torch.Generator().manual_seed(0), MATCH)
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra[2], rb[2])
        np.testing.assert_array_equal(ra[3], rb[3])


def test_features_cross_between_the_packages_through_numpy():
    """The JAX extractor's features in the port's matcher, and the port's
    in the JAX matcher: the same raw matches either way."""
    feats, u8 = _scene_features()
    port = convert.sift_features_to_numpy(feats)
    assert port["desc"].shape[:2] == port["valid"].shape and port["valid"].dtype == np.bool_
    jfeats = jsift.SiftFeatures(**{k: jnp.asarray(v) for k, v in port.items()})
    ref = jfront.FeatureMatcher().match(jfront.feature_slice(jfeats, 0),
                                        jfront.feature_slice(jfeats, 1))
    got = FeatureMatcher().match(feature_slice(feats, 0), feature_slice(feats, 1))
    assert int(got.num_matches) >= 20
    _assert_same_matches(got, ref)

    jex = jfront.FeatureExtractor(dataclasses.replace(jfront.SiftConfig(), max_features=1024))
    theirs = [jex.extract(u8[i]) for i in range(2)]
    back = [convert.sift_features_from_numpy(
        {k: np.asarray(getattr(f, k)) for k in port}) for f in theirs]
    assert back[0].desc.dtype == torch.float32 and back[0].valid.dtype == torch.bool
    _assert_same_matches(FeatureMatcher().match(*back), jfront.FeatureMatcher().match(*theirs))
    with pytest.raises(KeyError):
        convert.sift_features_from_numpy({"xy": port["xy"]})


def test_matches_from_numpy_normalises_types():
    m = convert.matches_from_numpy({
        (np.int64(0), 1): dict(idx1=[1, 2], idx2=np.array([3, 4], np.int32),
                               F=np.eye(3, dtype=np.float64), n=2),
        (0, 2): dict(idx1=np.zeros(0), idx2=np.zeros(0), F=np.ones(9), aux=True),
    })
    assert m[(0, 1)]["idx1"].dtype == np.int64 and m[(0, 1)]["F"].dtype == np.float32
    assert m[(0, 1)]["n"] == 2 and "aux" not in m[(0, 1)]
    assert m[(0, 2)]["aux"] is True and m[(0, 2)]["n"] == 0 and m[(0, 2)]["F"].shape == (3, 3)
    with pytest.raises(ValueError):
        convert.matches_from_numpy({(0, 1): dict(idx1=[1], idx2=[1, 2], F=np.eye(3))})
