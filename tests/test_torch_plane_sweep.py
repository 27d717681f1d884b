"""The port's plane sweep (recon3d_tpu_torch/dense/plane_sweep.py) against
the JAX package's on the CPU, on the scene of tests/test_plane_sweep.py.

On the CPU every K1 call of the port runs its plain version (the tent-warp
formula of the JAX bilinear_sample), which the JAX CPU path runs too; the
JAX function is jitted, as its package's own tests run it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recon3d_tpu.camera import Camera as JaxCamera
from recon3d_tpu.config import PlaneSweepConfig as JaxConfig
from recon3d_tpu.dense import plane_sweep as jps
from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import PlaneSweepConfig
from recon3d_tpu_torch.dense import plane_sweep as tps
from recon3d_tpu_torch.kernels import warp
from tests.render import render_views

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return render_views(n_views=5, image_size=(96, 128), arc_step=0.1)


def _args(scene):
    gray = scene["images"].mean(-1).astype(np.float32)
    ref, srcs = 2, [0, 1, 3, 4]
    gt = scene["depth"][ref]
    dr = np.asarray([gt[gt > 0].min() * 0.7, gt[gt > 0].max() * 1.4], np.float32)
    return (gray[ref], gray[srcs], np.asarray(scene["K"], np.float32),
            scene["Rs"][ref], scene["ts"][ref], scene["Rs"][srcs], scene["ts"][srcs], dr), gt


def test_plane_homography_matches_jax(rng):
    K = np.array([[120.0, 0, 64], [0, 118.0, 48], [0, 0, 1]], np.float32)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    for inv_d in (0.05, 0.3, 1.7):
        ref = jps.plane_homography(jnp.asarray(K), jnp.asarray(R), jnp.asarray(t), inv_d)
        got = tps.plane_homography(torch.from_numpy(K), torch.from_numpy(R),
                                   torch.from_numpy(t), torch.tensor(inv_d))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)
    Rr, tr = jps._relative_pose(*(jnp.asarray(a) for a in (R, t, R.T, -t)))
    Rp, tp = tps._relative_pose(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (R, t, R.T, -t)))
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rr), atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tr), atol=1e-5)


def test_linspace_matches_jnp():
    """jnp.linspace's formula: equal to 2 float32 ulp (XLA rewrites the
    division into a product by 1/(num - 1) and may contract into an FMA),
    both ends exact."""
    a, b = np.float32(1 / 7.3), np.float32(1 / 0.9)
    ref = np.asarray(jax.jit(lambda x, y: jnp.linspace(x, y, 64))(jnp.float32(a), jnp.float32(b)))
    got = tps._linspace(torch.tensor(a), torch.tensor(b), 64).numpy()
    np.testing.assert_array_max_ulp(got, ref, maxulp=2)
    assert got[0] == ref[0] == a and got[-1] == ref[-1] == b


def _agreement(d, c, d_ref, c_ref, min_views=3):
    """Share of the pixels confident in both runs whose depths agree within
    each relative bound, and the share of them with equal counts."""
    conf = (c_ref >= min_views) & (c >= min_views)
    rel = np.abs(d - d_ref) / d_ref
    return {t: float((rel[conf] < t).mean()) for t in (1e-3, 2e-2, 5e-2)}, \
        float((c[conf] == c_ref[conf]).mean())


@pytest.mark.parametrize("hierarchical", [True, False])
def test_sweep_depth_map_matches_jax(scene, hierarchical):
    """The port against the JAX sweep, each given the same inputs, held to
    the JAX sweep's agreement with itself on images scaled by 1 + 2^-22.

    Windowed NCC over flat, rendered texture is chaotic: the float32
    rounding of a homography's 3-term products changes warped samples by
    ~4e-6, which moves the NCC of a low-variance window by up to 0.6, and a
    plane may win by a hair. The JAX sweep on the perturbed images keeps
    only 38% (hierarchical) and 74% (exhaustive) of its confident pixels
    within 1e-3 relative depth of its own first run, 96% / 98% within 2e-2
    (tests/torch_reference_levels.py part 11). The
    port must agree with the JAX run at least as well, less 1% at each
    bound, with the same confident share to 1% and equal consistency counts
    on >= 99% of the pixels confident in both."""
    args, gt = _args(scene)
    kw = dict(num_depths=96, patch=5, ncc_threshold=0.7, min_views=3, hierarchical=hierarchical)
    fn = jax.jit(jps.sweep_depth_map, static_argnames=tuple(kw))
    d_j, c_j, _ = (np.asarray(a) for a in fn(*(jnp.asarray(a) for a in args), **kw))
    scaled = list(args)
    scaled[0], scaled[1] = args[0] * np.float32(1 + 2 ** -22), args[1] * np.float32(1 + 2 ** -22)
    d_j2, c_j2, _ = (np.asarray(a) for a in fn(*(jnp.asarray(a) for a in scaled), **kw))
    warp.counts.reset()
    d_t, c_t, _ = (a.numpy() for a in tps.sweep_depth_map(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args), **kw))
    # one K1 call per chunk of 8 planes, and one for the full-resolution candidates
    assert warp.counts.kernel == 0 and warp.counts.plain == 12 + hierarchical
    assert abs((c_j >= 3).mean() - (c_t >= 3).mean()) <= 0.01
    self_rel, _ = _agreement(d_j2, c_j2, d_j, c_j)
    port_rel, port_cnt = _agreement(d_t, c_t, d_j, c_j)
    for t in self_rel:
        assert port_rel[t] >= self_rel[t] - 0.01, (t, port_rel, self_rel)
    assert port_rel[5e-2] >= 0.99 and port_cnt >= 0.99
    # and the port alone meets the JAX test's accuracy gate
    ok = (c_t >= 3) & (gt > 0)
    err = np.abs(d_t[ok] - gt[ok]) / gt[ok]
    assert ok.mean() > 0.3 and np.median(err) < 0.05 and (err < 0.1).mean() > 0.8


def test_sweep_batch_equals_single_views(scene):
    """Three reference views swept as one batch give each view's own sweep."""
    gray = scene["images"].mean(-1).astype(np.float32)
    refs = [1, 2, 3]
    srcs = [[0, 2, 3], [1, 3, 4], [2, 4, 1]]
    T = torch.from_numpy
    Rs, ts = scene["Rs"].astype(np.float32), scene["ts"].astype(np.float32)
    K = T(np.asarray(scene["K"], np.float32))
    dr = torch.tensor([2.0, 8.0])
    kw = dict(num_depths=32, patch=5, ncc_threshold=0.7)
    d_b, c_b, _ = tps.sweep_depth_maps(
        T(gray[refs]), T(np.stack([gray[s] for s in srcs])), K, T(Rs[refs]), T(ts[refs]),
        T(np.stack([Rs[s] for s in srcs])), T(np.stack([ts[s] for s in srcs])), dr, **kw)
    for k, (r, s) in enumerate(zip(refs, srcs)):
        d, c, _ = tps.sweep_depth_map(T(gray[r]), T(gray[s]), K, T(Rs[r]), T(ts[r]),
                                      T(Rs[s]), T(ts[s]), dr, **kw)
        np.testing.assert_allclose(d_b[k].numpy(), d.numpy(), rtol=1e-6)
        np.testing.assert_array_equal(c_b[k].numpy(), c.numpy())


def test_plane_sweep_reconstructor_matches_jax(scene):
    """PlaneSweepReconstructor at the JAX test's settings: the JAX test's
    gate (> 3000 points, > 95% in front of the middle view), a point count
    within 5% of the JAX one, and depth maps for the mesh stage that agree
    with the JAX ones as well as the JAX ones agree with themselves on
    images scaled by 1 + 2^-22 (see test_sweep_depth_map_matches_jax),
    less 1%."""
    poses = {i: (scene["Rs"][i], scene["ts"][i]) for i in range(5)}
    kw = dict(scale=1.0, num_depths=64, min_views=3, voxel_size=0.01)
    jrec = jps.PlaneSweepReconstructor(JaxCamera.from_matrix(scene["K"]), JaxConfig(**kw))
    pj, cj, mj = jrec.reconstruct(scene["images"], poses, return_maps=True)
    _, _, mj2 = jrec.reconstruct(scene["images"] * np.float32(1 + 2 ** -22), poses,
                                 return_maps=True)
    warp.counts.reset()
    pt, ct, mt = tps.PlaneSweepReconstructor(
        Camera.from_matrix(scene["K"]), PlaneSweepConfig(**kw), device="cpu"
    ).reconstruct(scene["images"], poses, return_maps=True)
    assert warp.counts.plain == 8 + 1 and warp.counts.kernel == 0  # 8 chunks, the candidates
    assert len(pt) > 3000 and ct.shape == pt.shape and ct.dtype == np.uint8
    Xc = pt @ scene["Rs"][2].T + scene["ts"][2]
    assert (Xc[:, 2] > 0).mean() > 0.95
    assert abs(len(pt) / len(pj) - 1) < 0.05, (len(pt), len(pj))
    assert mt["ids"] == mj["ids"]
    np.testing.assert_allclose(mt["K"], mj["K"], rtol=1e-6)
    np.testing.assert_allclose(mt["Rs"], mj["Rs"], atol=1e-6)
    self_rel, self_cnt = _agreement(mj2["depth"], mj2["conf"], mj["depth"], mj["conf"])
    rel, cnt = _agreement(mt["depth"].numpy(), mt["conf"].numpy(), mj["depth"], mj["conf"])
    for t in self_rel:
        assert rel[t] >= self_rel[t] - 0.01, (t, rel, self_rel)
    assert cnt >= self_cnt - 0.01, (cnt, self_cnt)


def test_plane_sweep_reconstructor_too_few_views(scene):
    rec = tps.PlaneSweepReconstructor(Camera.from_matrix(scene["K"]), device="cpu")
    pts, cols, maps = rec.reconstruct(scene["images"][:1], {0: (scene["Rs"][0], scene["ts"][0])},
                                      return_maps=True)
    assert pts.shape == (0, 3) and cols.shape == (0, 3) and maps is None
