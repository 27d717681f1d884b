"""SIFT front end of the PyTorch port against the JAX package (CPU):
blur and pyramid, CLAHE, detection and description, the two-phase batch.

The same numpy images go through both. The convolutions of the two
backends add their taps in different orders, so the DoG volumes differ in
the last bits and a borderline candidate may fall on the other side of a
threshold; the port is therefore held to the agreement that the JAX
extractor shows with itself on the same image scaled by 1 + 2^-22
(sift_agreement_levels, printed by tests/torch_reference_levels.py part 5),
not to bit equality.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recon3d_tpu.ops import clahe as jclahe
from recon3d_tpu.ops import image as jimg
from recon3d_tpu.ops import sift as jsift
from recon3d_tpu_torch.config import SiftConfig
from recon3d_tpu_torch.features.frontend import FeatureExtractor, feature_slice
from recon3d_tpu_torch.ops import clahe as tclahe
from recon3d_tpu_torch.ops import image as timg
from recon3d_tpu_torch.ops import sift as tsift
from tests.render import render_views

H, W = 96, 128
DETECT = dict(max_features=512, num_octaves=4, scales=3, sigma0=1.6,
              contrast_threshold=0.03, edge_threshold=15.0)
CAPS_SEL = (256, 128)          # describe-phase capacities (96x128 has two octaves)
PAIR_PX = 0.05                 # keypoints closer than this are the same keypoint
MIN_COS = 0.999                # descriptor cosine of a paired keypoint

# The test workers share the machine's cores: PyTorch's default of one
# thread per core in every worker makes them wait on one another.
torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _images() -> np.ndarray:
    """Two rendered views and one band-limited random texture, (3, H, W)."""
    from scipy.ndimage import gaussian_filter

    scene = render_views(n_views=2, image_size=(H, W), arc_step=0.1)
    gray = [im @ np.array([0.299, 0.587, 0.114], np.float32) for im in scene["images"]]
    tex = gaussian_filter(np.random.default_rng(0).random((H, W)), 2.0)
    gray.append((tex - tex.min()) / (tex.max() - tex.min()))
    return np.stack(gray).astype(np.float32)


def _valid_np(feats_xy, feats_desc, feats_valid):
    v = np.asarray(feats_valid)
    return np.asarray(feats_xy)[v], np.asarray(feats_desc)[v]


def _pair(xy_a, desc_a, xy_b, desc_b):
    """For each keypoint of a: the keypoint of b within PAIR_PX of it (of
    several at one position, as secondary orientations give, the one with
    the closest descriptor). Returns (share of a that has one, descriptor
    cosines of the pairs, b-indices of the pairs in a's order)."""
    near = np.linalg.norm(xy_a[:, None] - xy_b[None], axis=-1) < PAIR_PX
    cos = np.where(near, desc_a @ desc_b.T, -np.inf)
    j = cos.argmax(1)
    ok = near.any(1)
    return float(ok.mean()), cos[np.arange(len(xy_a)), j][ok], j[ok]


@functools.lru_cache(maxsize=None)
def _jax_two_phase():
    def fn(img):
        pyr, dets, _ = jsift.detect_sift(img, **DETECT)
        return jsift.describe_sift(pyr, dets, CAPS_SEL)

    return jax.jit(fn)


def _jax_features(img: np.ndarray):
    f = _jax_two_phase()(jnp.asarray(img))
    return _valid_np(f.xy, f.desc, f.valid)


def _port_features(img: np.ndarray):
    pyr, dets, _ = tsift.detect_sift(torch.from_numpy(img), **DETECT)
    f = tsift.describe_sift(pyr, dets, CAPS_SEL)
    return _valid_np(f.xy.numpy(), f.desc.numpy(), f.valid.numpy())


def sift_agreement_levels():
    """Per test image: how the JAX extractor agrees with itself on the
    image scaled by 1 + 2^-22, and how the port agrees with it."""
    out = []
    for img in _images():
        ref = _jax_features(img)
        for name, other in (("jax on the scaled image",
                             _jax_features(img * np.float32(1 + 2 ** -22))),
                            ("port", _port_features(img))):
            share, cos, j = _pair(*ref, *other)
            out.append({"against": name, "keypoints": len(ref[0]), "paired_share": share,
                        "cos_share": float((cos >= MIN_COS).mean()),
                        "cos_min": float(cos.min()),
                        "same_order": bool((np.diff(j) > 0).all())})
    return out


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sigma", [0.8, 1.6, 3.2])
def test_gaussian_blur_matches_jax(sigma):
    img = _images()[0]
    ref = jimg.gaussian_blur(jnp.asarray(img), sigma)
    got = timg.gaussian_blur(torch.from_numpy(img), sigma)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(timg.gaussian_kernel1d(sigma), jimg.gaussian_kernel1d(sigma))


def test_gradients_and_decimation_match_jax():
    img = _images()[2]
    t = torch.from_numpy(img)
    for name in ("sobel", "central_gradients"):
        for got, ref in zip(getattr(timg, name)(t), getattr(jimg, name)(jnp.asarray(img))):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(timg.downsample2(t).numpy(),
                                  np.asarray(jimg.downsample2(jnp.asarray(img))))
    # a leading batch is one image at a time (the CPU convolution may pick
    # another summation order for another batch size: 1e-6)
    batch = timg.gaussian_blur(torch.from_numpy(_images()), 1.6)
    np.testing.assert_allclose(batch[2].numpy(), timg.gaussian_blur(t, 1.6).numpy(),
                               atol=1e-6, rtol=0)


def test_build_pyramid_matches_jax():
    img = _images()[0]
    ref = jax.jit(lambda im: jsift.build_pyramid(im, 3, 3, 1.6))(jnp.asarray(img))
    got = tsift.build_pyramid(torch.from_numpy(img), 3, 3, 1.6)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)
    batch = tsift.build_pyramid(torch.from_numpy(_images()), 3, 3, 1.6)
    np.testing.assert_allclose(batch[1][0].numpy(), got[1].numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("grid,clip", [(8, 2.0), (4, 3.0), (1, 2.0)])
def test_clahe_matches_jax(grid, clip):
    imgs = _images()
    u8 = (imgs * 255).astype(np.uint8).astype(np.float32) / 255.0   # as extract_batch feeds it
    for x in (imgs, u8):
        ref = np.stack([np.asarray(jclahe.clahe(jnp.asarray(i), clip, grid)) for i in x])
        got = tclahe.clahe(torch.from_numpy(x), clip, grid)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_detect_and_describe_agree_with_jax_as_well_as_jax_with_itself():
    levels = sift_agreement_levels()
    for self_level, port_level in zip(levels[0::2], levels[1::2]):
        assert port_level["keypoints"] >= 25
        assert port_level["paired_share"] >= self_level["paired_share"] >= 0.9
        assert port_level["cos_share"] >= self_level["cos_share"]
        assert port_level["cos_min"] >= MIN_COS
        assert port_level["same_order"]


def test_valid_keypoints_come_in_the_jax_order_with_the_jax_values():
    """Same count, same slots: slot k of the port is slot k of the JAX
    extractor (position within PAIR_PX, scale and angle close)."""
    img = _images()[2]
    f = _jax_two_phase()(jnp.asarray(img))
    pyr, dets, counts = tsift.detect_sift(torch.from_numpy(img), **DETECT)
    g = tsift.describe_sift(pyr, dets, CAPS_SEL)
    vj, vt = np.asarray(f.valid), g.valid.numpy()
    np.testing.assert_array_equal(vj, vt)
    assert g.desc.shape == (sum(CAPS_SEL), 128) and int(counts.sum()) == vt.sum() > 60
    np.testing.assert_allclose(g.xy.numpy()[vt], np.asarray(f.xy)[vj], atol=PAIR_PX)
    np.testing.assert_allclose(g.scale.numpy()[vt], np.asarray(f.scale)[vj], rtol=1e-3)
    np.testing.assert_allclose(g.response.numpy()[vt], np.asarray(f.response)[vj], atol=1e-5)
    dang = np.abs(g.angle.numpy()[vt] - np.asarray(f.angle)[vj])
    assert np.minimum(dang, 2 * np.pi - dang).max() < 1e-2
    resp = g.response.numpy()[vt]
    assert (np.diff(resp) <= 0).all()                       # sorted by response
    np.testing.assert_allclose(np.linalg.norm(g.desc.numpy()[vt], axis=1), 1.0, atol=1e-4)


@pytest.mark.parametrize("option", ["multi_orientation", "upsample"])
def test_extract_sift_options_match_jax(option):
    img = _images()[0]
    kw = dict(DETECT, max_features=256, **{option: True})
    f = jax.jit(lambda im: jsift.extract_sift(im, **kw))(jnp.asarray(img))
    g = tsift.extract_sift(torch.from_numpy(img), **kw)
    assert g.valid.shape == f.valid.shape
    ref, got = _valid_np(f.xy, f.desc, f.valid), _valid_np(g.xy.numpy(), g.desc.numpy(),
                                                          g.valid.numpy())
    assert abs(len(ref[0]) - len(got[0])) <= 1
    share, cos, j = _pair(*ref, *got)
    assert share >= 0.95 and (cos >= MIN_COS).mean() >= 0.95
    if option == "multi_orientation":
        # secondary keypoints share their position with a primary one
        xy = got[0]
        d = np.linalg.norm(xy[:, None] - xy[None], axis=-1) + np.eye(len(xy))
        assert (d.min(1) < 1e-6).sum() >= 2


def test_batched_extraction_equals_one_image_at_a_time():
    """Slot for slot. Not bit for bit: the CPU convolution's summation
    order depends on the batch size, and the subpixel solve amplifies the
    last bits of the DoG (0.02 px, cosine 0.999)."""
    imgs = torch.from_numpy(_images())
    batch = tsift.extract_sift(imgs, **DETECT)
    for i in range(len(imgs)):
        one = tsift.extract_sift(imgs[i], **DETECT)
        part = feature_slice(batch, i)
        v = one.valid.numpy()
        np.testing.assert_array_equal(part.valid.numpy(), v)
        np.testing.assert_allclose(part.xy.numpy()[v], one.xy.numpy()[v], atol=0.02)
        np.testing.assert_allclose(part.response.numpy()[v], one.response.numpy()[v], atol=1e-6)
        cos = (part.desc.numpy()[v] * one.desc.numpy()[v]).sum(-1)
        assert cos.min() >= MIN_COS


def test_two_phase_extract_matches_single_phase():
    """extract_batch's two-phase path (detect at the worst-case capacity,
    describe at the bucketed selection capacity) gives exactly the
    single-phase extract()'s keypoints and descriptors: the selection keeps
    every valid candidate, only the dead padded slots shrink."""
    scene = render_views(n_views=2, image_size=(240, 320), arc_step=0.1)
    gray = np.stack([im.mean(-1) for im in scene["images"]]).astype(np.float32)
    ex = FeatureExtractor(device="cpu")
    feats2 = ex.extract_batch(gray)
    assert feats2.valid.shape[1] < ex.extract(gray[0]).valid.shape[0]
    u8 = np.clip(gray * 255.0, 0, 255).astype(np.uint8)
    for i in range(2):
        f1 = ex.extract(u8[i].astype(np.float32) / 255.0)
        xy1, d1 = _valid_np(f1.xy.numpy(), f1.desc.numpy(), f1.valid.numpy())
        f2 = feature_slice(feats2, i)
        xy2, d2 = _valid_np(f2.xy.numpy(), f2.desc.numpy(), f2.valid.numpy())
        assert len(xy1) > 150
        np.testing.assert_array_equal(xy1, xy2)            # same set, same order
        np.testing.assert_allclose(d1, d2, atol=1e-6)


def test_extract_batch_windows_join_at_the_largest_capacity():
    """Three windows of one chunk each; the flat image's window selects the
    smallest capacity and is padded with invalid slots when joined."""
    imgs = np.concatenate([_images(), np.full((1, H, W), 0.5, np.float32)])
    cfg = dataclasses.replace(SiftConfig(), max_features=2048)
    ex = FeatureExtractor(cfg, device="cpu")
    tm = {}
    joined = ex.extract_batch(imgs, chunk=2, max_inflight_chunks=1, timings=tm)
    whole = ex.extract_batch(imgs, chunk=4)
    assert joined.valid.shape == whole.valid.shape and joined.desc.shape[0] == 4
    assert int(joined.valid[3].sum()) == 0
    for i in range(4):
        v = whole.valid[i]
        np.testing.assert_array_equal(joined.valid[i].numpy(), v.numpy())
        np.testing.assert_array_equal(joined.xy[i][v].numpy(), whole.xy[i][v].numpy())
        np.testing.assert_array_equal(joined.desc[i][v].numpy(), whole.desc[i][v].numpy())
    assert set(tm) >= {"host_prep_s", "detect_dispatch_s", "counts_sync_s",
                       "describe_dispatch_s", "concat_s"}


def test_feature_extractor_raises_without_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        FeatureExtractor()
