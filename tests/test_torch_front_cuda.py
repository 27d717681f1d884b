"""The SfM front end on the card against the same code on the CPU.

Keypoint order decides every index downstream, and the selections of
ops/select.py exist so that it is the same on both devices. Every test
here is marked `cuda` and skips without a GPU. The file imports neither
jax nor the JAX package, so it also runs on a GPU machine without them:

    python -m pytest --noconftest tests/test_torch_front_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from recon3d_tpu_torch.config import MatchConfig, SiftConfig
from recon3d_tpu_torch.features.frontend import FeatureExtractor, match_pairs_batched
from recon3d_tpu_torch.ops import linalg, match, select

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (compares the card with the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _images():
    rng = np.random.default_rng(0)
    base = rng.random((3, 30, 40)).astype(np.float32)
    # band-limited texture: a smooth upsampling of coarse noise
    up = torch.nn.functional.interpolate(torch.from_numpy(base)[None], size=(120, 160),
                                         mode="bicubic", align_corners=False)[0]
    return up.clamp(0, 1).numpy()


def test_selections_break_ties_by_the_lower_index_on_the_card(cuda_device):
    x = torch.tensor([[3.0, 1.0, 1.0, 3.0, 0.5], [2.0, 2.0, 2.0, 2.0, 2.0]], device="cuda")
    assert select.argmin_first(x, -1).tolist() == [4, 0]
    assert select.argmax_first(x, -1).tolist() == [0, 0]
    assert select.topk_nonneg_first(x, 3)[1].tolist() == [[0, 3, 1], [0, 1, 2]]
    big = torch.zeros((2, 1 << 20), device="cuda")
    big[:, ::1000] = 0.25                       # 1,049 equal scores among the filler
    idx = select.topk_nonneg_first(big, 2048)[1]
    scored = torch.arange(0, 1 << 20, 1000)
    filler = torch.tensor([i for i in range(1, 1200) if i % 1000][: 2048 - len(scored)])
    np.testing.assert_array_equal(idx[0].cpu().numpy(), torch.cat([scored, filler]).numpy())


def test_extraction_gives_the_same_keypoints_in_the_same_order(cuda_device):
    cfg = dataclasses.replace(SiftConfig(), max_features=1024)
    imgs = _images()
    on_cpu = FeatureExtractor(cfg, device="cpu").extract_batch(imgs)
    on_card = FeatureExtractor(cfg, device="cuda").extract_batch(imgs)
    assert on_card.desc.device.type == "cuda"
    v = on_cpu.valid.numpy()
    assert v.sum(1).min() > 40
    np.testing.assert_array_equal(on_card.valid.cpu().numpy(), v)
    np.testing.assert_allclose(on_card.xy.cpu().numpy()[v], on_cpu.xy.numpy()[v], atol=0.05)
    cos = (on_card.desc.cpu().numpy()[v] * on_cpu.desc.numpy()[v]).sum(-1)
    assert np.mean(cos >= 0.999) >= 0.95


def test_matching_gives_the_same_indices(cuda_device):
    rng = np.random.default_rng(1)
    d1 = rng.normal(size=(2, 300, 32)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = np.concatenate([d1[:, :150] + 0.05 * rng.normal(size=(2, 150, 32)).astype(np.float32),
                         d1[:, 100:150], d1[:, 200:300]], axis=1)     # with exact copies
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    v1 = np.ones((2, 300), np.float32)
    v2 = np.ones((2, 300), np.float32)
    v2[:, 280:] = 0
    args = [torch.from_numpy(a) for a in (d1, d2, v1, v2)]
    a = match.match_descriptors_streaming(*args, block=128)
    b = match.match_descriptors_streaming(*[t.cuda() for t in args], block=128)
    # the matrix product rounds differently; away from exact ties only
    # near-equal candidates may swap, and there are none in this input
    np.testing.assert_array_equal(b.mask.cpu().numpy(), a.mask.numpy())
    np.testing.assert_array_equal(b.idx2.cpu().numpy(), a.idx2.numpy())
    assert int(a.mask.sum()) > 150


def test_smallest_eigvec_takes_a_whole_chunk_of_hypotheses(cuda_device):
    """64 pairs x 1,024 hypotheses: more matrices than the batched solver
    accepts in one call."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    A = torch.randn((64, 1024, 12, 9), generator=gen, device="cuda")
    AtA = A.transpose(-1, -2) @ A
    v = linalg.smallest_eigvec(AtA)
    assert v.shape == (64, 1024, 9)
    resid = torch.linalg.norm(torch.einsum("...ij,...j->...i", AtA, v), dim=-1)
    lam = torch.linalg.eigvalsh(AtA[0, :8].cpu())[:, 0]
    np.testing.assert_allclose(resid[0, :8].cpu().numpy(), lam.numpy(), rtol=1e-2, atol=1e-3)


def test_match_stage_keeps_the_same_pairs_on_both_devices(cuda_device):
    cfg = dataclasses.replace(SiftConfig(), max_features=1024)
    mcfg = dataclasses.replace(MatchConfig(), ransac_hypotheses=256)
    imgs = _images()
    shifted = np.roll(imgs, 3, axis=2)          # the same texture, moved by 3 px
    views = np.concatenate([imgs[:1], shifted[:1], imgs[1:2], shifted[1:2]])
    pairs = [(0, 1), (2, 3), (0, 2)]
    out = {}
    for dev in ("cpu", "cuda"):
        feats = FeatureExtractor(cfg, device=dev).extract_batch(views)
        gen = torch.Generator(device=dev).manual_seed(0)
        out[dev] = match_pairs_batched(feats, pairs, gen, mcfg)
    for a, b in zip(out["cpu"], out["cuda"]):
        assert a[6] == b[6]                                   # raw matches: no draws
        assert abs(a[5] - b[5]) <= max(2, 0.1 * a[5])         # inliers: other draws
    assert out["cuda"][0][5] >= 20 and out["cuda"][1][5] >= 20
    assert out["cuda"][2][5] < 20                             # unrelated textures


@pytest.mark.parametrize("option", ["multi_orientation", "upsample"])
def test_extraction_options_give_the_same_keypoints_on_both_devices(cuda_device, option):
    """SiftConfig's multi_orientation (a secondary orientation per peak of
    the histogram) and upsample (the pyramid starts one octave below the
    image): the same slots on the card as on the CPU."""
    cfg = dataclasses.replace(SiftConfig(), max_features=1024, **{option: True})
    imgs = _images()
    on_cpu = FeatureExtractor(cfg, device="cpu").extract_batch(imgs)
    on_card = FeatureExtractor(cfg, device="cuda").extract_batch(imgs)
    v = on_cpu.valid.numpy()
    assert v.sum(1).min() > 40
    np.testing.assert_array_equal(on_card.valid.cpu().numpy(), v)
    np.testing.assert_allclose(on_card.xy.cpu().numpy()[v], on_cpu.xy.numpy()[v], atol=0.05)
    np.testing.assert_allclose(on_card.angle.cpu().numpy()[v], on_cpu.angle.numpy()[v],
                               atol=0.02)
    cos = (on_card.desc.cpu().numpy()[v] * on_cpu.desc.numpy()[v]).sum(-1)
    assert np.mean(cos >= 0.999) >= 0.95


def test_long_span_rematch_recovers_the_same_pairs_on_both_devices(cuda_device, monkeypatch):
    """The rematch's recovered branch (tests/test_torch_sfm_front.py holds
    it to the JAX pipeline on the CPU): 10 views at match_window=2 with
    the homography gate held open (the rendered scene is made of planes,
    so the gate would reject every probe pair). On the card as on the CPU
    the same aux pairs are recovered, with inlier counts within a tenth,
    their keypoints appended behind each view's load-resolution table."""
    from collections import namedtuple

    from recon3d_tpu_torch.camera import Camera
    from recon3d_tpu_torch.config import ReconstructionConfig
    from recon3d_tpu_torch.io.dataset import image_set_from_arrays
    from recon3d_tpu_torch.sfm import pipeline as tpipe
    from tests.render import render_views

    no_plane = namedtuple("HomographyResult", "H inliers num_inliers")(None, None, 0)
    monkeypatch.setattr(tpipe, "estimate_homography_ransac", lambda *a, **k: no_plane)
    scene = render_views(n_views=10, image_size=(120, 160), arc_step=0.12)
    cfg = ReconstructionConfig()
    cfg = cfg.replace(sift=dataclasses.replace(cfg.sift, max_features=1024),
                      match=dataclasses.replace(cfg.match, ransac_hypotheses=256),
                      sfm=dataclasses.replace(cfg.sfm, match_window=2))
    runs = {}
    for dev in ("cpu", "cuda"):
        pipe = tpipe.SfMPipeline(config=cfg, device=dev)
        pipe.set_image_set(image_set_from_arrays(scene["images"],
                                                 Camera.from_matrix(scene["K"])))
        pipe.extract_features()
        before = [len(k) for k in pipe.kp_xy]
        pipe.match_image_pairs()
        runs[dev] = (pipe, before)
    (cpu, _), (card, before) = runs["cpu"], runs["cuda"]
    aux = {p for p, m in card.matches.items() if m.get("aux")}
    assert card.stats["rematch_recovered"] == len(aux) >= 1
    assert aux == {p for p, m in cpu.matches.items() if m.get("aux")}
    for (i, j) in aux:
        m, r = card.matches[(i, j)], cpu.matches[(i, j)]
        assert abs(m["n"] - r["n"]) <= max(2, 0.1 * r["n"])
        assert m["idx1"].min() >= before[i] and m["idx2"].min() >= before[j]
        assert m["idx1"].max() < len(card.kp_xy[i]) == len(card.kp_to_point[i])
    assert [len(k) for k in card.kp_xy] == [len(k) for k in cpu.kp_xy]
