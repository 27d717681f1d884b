"""PatchMatch MVS in the PyTorch port against the JAX reference (CPU).

The port cannot reproduce jax.random, so every parity test rebuilds the
JAX run's coarse random grids from its key (jax.random.split / fold_in, as
recon3d_tpu/dense/patchmatch.py:332, :272 and :277 make them) and hands
them to the port.

PatchMatch is chaotic at the 1e-3 level: a candidate whose windowed NCC
differs in the last bits can win an argmin and then propagate. The
reference itself, rerun on images scaled by (1 + 2**-22), keeps only ~71%
of pixels within 1e-3 relative depth of its own first run on this scene.
So the end-to-end parity gate compares the port's agreement with the
reference to the reference's agreement with itself under that perturbation,
and the building blocks are held to tight tolerances on identical inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import recon3d_tpu.dense.patchmatch as jpm
from recon3d_tpu.camera import Camera as JaxCamera
from recon3d_tpu.config import PatchMatchConfig as JaxPatchMatchConfig
from recon3d_tpu.dense import plane_sweep as jps
from recon3d_tpu.ops.ncc import ncc_windowed as jax_ncc
import recon3d_tpu_torch.dense.patchmatch as tpm
from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import PatchMatchConfig
from recon3d_tpu_torch.dense import plane_sweep as tps
from recon3d_tpu_torch.ops.ncc import ncc_windowed
from tests.render import render_views
from tests.torch_scene import sparse_from_depth, surface_gate

REF, SRCS = 2, [0, 1, 3, 4]


@pytest.fixture(scope="module")
def scene():
    return render_views(n_views=5, image_size=(96, 128), arc_step=0.12)


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def _inputs(scene, ref=REF, srcs=SRCS):
    gray = scene["images"].mean(-1).astype(np.float32)
    gt = scene["depth"][ref]
    dr = np.array([gt[gt > 0].min() * 0.7, gt[gt > 0].max() * 1.4], np.float32)
    return [gray[ref], gray[srcs], scene["K"], scene["Rs"][ref], scene["ts"][ref],
            scene["Rs"][srcs], scene["ts"][srcs], dr]


def jax_coarse_fields(key, H, W, num_iterations=3, num_samples=8,
                      coarse_factor=4, fine_iterations=1):
    """The grids of every _smooth_field call of jax patchmatch_depth(key),
    in call order: the init field, one per coarse round, one per fine
    round (single-level: init and one per round)."""
    k_init, k_coarse, k_fine = jax.random.split(key, 3)
    two = coarse_factor > 1 and min(H, W) >= 4 * coarse_factor
    h, w = (H // coarse_factor, W // coarse_factor) if two else (H, W)

    def grid(k, lead, hh, ww):
        return jax.random.uniform(k, lead + (hh // 8 + 2, ww // 8 + 2),
                                  jnp.float32, -1.0, 1.0)

    out = [grid(k_init, (), h, w)]
    for it in range(num_iterations):
        out.append(grid(jax.random.fold_in(k_coarse, it), (num_samples,), h, w))
    if two:
        for it in range(num_iterations, num_iterations + fine_iterations):
            out.append(grid(jax.random.fold_in(k_fine, it),
                            (max(num_samples // 2, 2),), H, W))
    return [torch.from_numpy(np.array(f)) for f in out]


def _run_jax(inputs, key, **kw):
    return jpm.patchmatch_depth(*[jnp.asarray(a) for a in inputs], key, **kw)


def _run_port(inputs, key, **kw):
    H, W = inputs[0].shape
    fields = jax_coarse_fields(key, H, W, num_iterations=kw.get("num_iterations", 3))
    return tpm.patchmatch_depth(*[T(a) for a in inputs], coarse_fields=fields, **kw)


def test_shift2d_edges_and_clamp():
    x = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    for dy, dx in [(1, 0), (-1, 0), (0, 1), (0, -1), (2, -3), (16, 0), (0, -16)]:
        np.testing.assert_array_equal(
            tpm._shift2d(T(x), dy, dx).numpy(), np.asarray(jpm._shift2d(jnp.asarray(x), dy, dx))
        )
    b = tpm._shift2d(T(np.stack([x, -x])), 1, -2, dims=(1, 2))
    np.testing.assert_array_equal(b[1].numpy(), -tpm._shift2d(T(x), 1, -2).numpy())


def test_ncc_windowed_matches_jax_on_identical_inputs(rng):
    ref = rng.random((30, 40)).astype(np.float32)
    src = (ref[None] * 0.8 + 0.2 * rng.random((3, 30, 40))).astype(np.float32)
    ok = rng.random((3, 30, 40)) > 0.2
    a = np.asarray(jax_ncc(jnp.asarray(ref), jnp.asarray(src), jnp.asarray(ok), 7))
    b = ncc_windowed(T(ref), T(src), torch.from_numpy(ok), 7).numpy()
    # same float32 operations in the same order (box sums included): 1e-6
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)


def test_warp_and_eval_cost_match_jax_for_fixed_depth(scene):
    ref_g, src_g, K, Rr, tr, Rs, ts, _ = _inputs(scene)
    H, W = ref_g.shape
    gt = scene["depth"][REF]
    depth = np.where(gt > 0, gt, 4.0).astype(np.float32)
    rays_j = jpm._rays_for(jnp.asarray(K), H, W, jnp.float32)
    rays_t = tpm._rays_for(T(K), H, W, torch.float32)
    np.testing.assert_allclose(rays_t.numpy(), np.asarray(rays_j), atol=1e-6)
    zf = 0.1
    wj, okj = jpm._warp_sources(jnp.asarray(depth), rays_j, jnp.asarray(Rr), jnp.asarray(tr),
                                jnp.asarray(Rs), jnp.asarray(ts), jnp.asarray(K),
                                jnp.asarray(src_g), z_floor=zf)
    wt, okt = tpm._warp_sources(T(depth)[None, None], rays_t, T(Rr)[None], T(tr)[None],
                                T(Rs)[None], T(ts)[None], T(K), T(src_g)[None],
                                torch.tensor([zf]))
    # reprojection: 3x3 products added in another order (~1e-5 px), times
    # the image gradient: 1e-5 on the samples
    np.testing.assert_array_equal(okt[0, :, 0].numpy(), np.asarray(okj))
    np.testing.assert_allclose(wt[0, :, 0].numpy(), np.asarray(wj), atol=1e-5, rtol=0)
    cj, nj, _ = jpm._eval_cost(jnp.asarray(depth), rays_j, jnp.asarray(ref_g),
                               jnp.asarray(src_g), jnp.asarray(K), jnp.asarray(Rr),
                               jnp.asarray(tr), jnp.asarray(Rs), jnp.asarray(ts), 7,
                               z_floor=zf)
    ct, nt, _ = tpm._eval_cost(T(depth)[None, None], rays_t, T(ref_g)[None], T(src_g)[None],
                               T(K), T(Rr)[None], T(tr)[None], T(Rs)[None], T(ts)[None], 7,
                               torch.tensor([zf]))
    # Windowed NCC divides by window variances; in smooth windows it
    # amplifies those 1e-5 sample differences. Measured bound: cost within
    # 1e-4 on 90% of pixels, 1e-3 on 98%, 0.05 everywhere; and always
    # closer to the reference than the reference is to itself on images
    # changed by two float32 ulps.
    dc = np.abs(ct[0, 0].numpy() - np.asarray(cj))
    dn = np.abs(nt[0, :, 0].numpy() - np.asarray(nj))
    assert (dc < 1e-4).mean() > 0.90 and (dc < 1e-3).mean() > 0.98 and dc.max() < 0.05
    assert (dn < 1e-4).mean() > 0.95 and dn.max() < 0.1
    s = np.float32(1 + 2 ** -22)
    cj2, _, _ = jpm._eval_cost(jnp.asarray(depth), rays_j, jnp.asarray(ref_g * s),
                               jnp.asarray(src_g * s), jnp.asarray(K), jnp.asarray(Rr),
                               jnp.asarray(tr), jnp.asarray(Rs), jnp.asarray(ts), 7,
                               z_floor=zf)
    d_self = np.abs(np.asarray(cj2) - np.asarray(cj))
    for thr in (1e-5, 1e-4, 1e-3):
        assert (dc < thr).mean() >= (d_self < thr).mean(), thr


def test_normals_from_depth_matches_jax(scene):
    K = scene["K"]
    gt = scene["depth"][REF]
    depth = np.where(gt > 0, gt, 4.0).astype(np.float32)
    rays = jpm._rays_for(jnp.asarray(K), 96, 128, jnp.float32)
    a = np.asarray(jpm.normals_from_depth(jnp.asarray(depth), rays))
    b = tpm.normals_from_depth(T(depth), T(np.asarray(rays))).numpy()
    np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)  # unit vectors, f32
    np.testing.assert_allclose(np.linalg.norm(b, axis=-1), 1.0, atol=1e-5)


def test_smooth_field_given_jax_draws():
    key = jax.random.PRNGKey(5)
    grid = jax.random.uniform(key, (8, 5, 6), jnp.float32, -1.0, 1.0)
    jf = np.asarray(jpm._smooth_field(key, (8, 24, 32)))
    tf = tpm._smooth_field((8, 24, 32), coarse=torch.from_numpy(np.array(grid))).numpy()
    np.testing.assert_allclose(tf, jf, atol=1e-6, rtol=0)
    g = [torch.Generator().manual_seed(s) for s in (1, 2)]
    two = tpm._smooth_field((2, 8, 24, 32), generator=g)
    one = tpm._smooth_field((8, 24, 32), generator=torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(two[1].numpy(), one.numpy())


def test_patchmatch_depth_tracks_jax_given_its_draws(scene):
    """Agreement with the reference at least as close as the reference's
    agreement with itself on images changed by two float32 ulps; and the
    same accuracy against the ground truth."""
    inputs = _inputs(scene)
    key = jax.random.PRNGKey(0)
    kw = dict(num_iterations=2, patch=7)
    j = _run_jax(inputs, key, **kw)
    p = _run_port(inputs, key, **kw)
    perturbed = list(inputs)
    perturbed[0] = inputs[0] * np.float32(1 + 2 ** -22)
    perturbed[1] = inputs[1] * np.float32(1 + 2 ** -22)
    j2 = _run_jax(perturbed, key, **kw)
    jd, pd = np.asarray(j.depth), p.depth.numpy()
    rel = np.abs(pd - jd) / jd
    rel_self = np.abs(np.asarray(j2.depth) - jd) / jd
    for thr in (1e-3, 1e-2, 3e-2):
        assert (rel < thr).mean() >= (rel_self < thr).mean() - 0.03, thr
    assert (rel < 0.1).mean() > 0.98
    same = rel < 1e-3
    assert (p.confidence.numpy()[same] == np.asarray(j.confidence)[same]).mean() > 0.98
    gt = scene["depth"][REF]
    conf = (np.asarray(j.confidence) >= 3) & (gt > 0)
    err_j = np.median(np.abs(jd[conf] - gt[conf]) / gt[conf])
    err_p = np.median(np.abs(pd[conf] - gt[conf]) / gt[conf])
    assert err_p < 1.15 * err_j + 1e-3, (err_p, err_j)


def test_patchmatch_depth_accuracy(scene):
    """Port alone: the gates of tests/test_patchmatch.py."""
    inputs = _inputs(scene)
    out = tpm.patchmatch_depth(*[T(a) for a in inputs], num_iterations=4, patch=7,
                               generator=torch.Generator().manual_seed(0))
    gt = scene["depth"][REF]
    depth = out.depth.numpy()
    conf = (out.confidence.numpy() >= 3) & (gt > 0)
    assert conf.mean() > 0.3, f"too few confident pixels: {conf.mean():.2%}"
    rel = np.abs(depth[conf] - gt[conf]) / gt[conf]
    assert np.median(rel) < 0.03, f"median rel depth err {np.median(rel):.3f}"
    assert (rel < 0.1).mean() > 0.8
    assert out.normal.shape == (96, 128, 3) and out.cost.shape == (96, 128)


def test_patchmatch_deterministic_and_batch_matches_single(scene):
    inputs = [T(a) for a in _inputs(scene, 2, [1, 3])]
    run = lambda s: tpm.patchmatch_depth(*inputs, num_iterations=2, patch=7,
                                         generator=torch.Generator().manual_seed(s))
    a, b, c = run(7), run(7), run(8)
    np.testing.assert_array_equal(a.depth.numpy(), b.depth.numpy())
    assert not np.array_equal(a.depth.numpy(), c.depth.numpy())

    gray = scene["images"].mean(-1).astype(np.float32)
    gt = scene["depth"]
    refs, srcs = [1, 2], {1: [0, 2, 3], 2: [1, 3, 4]}
    dr = np.stack([[gt[r][gt[r] > 0].min() * 0.7, gt[r][gt[r] > 0].max() * 1.4]
                   for r in refs]).astype(np.float32)
    gens = [torch.Generator().manual_seed(s) for s in (3, 4)]
    out = tpm.patchmatch_depth_batch(
        T(gray[refs]), T(np.stack([gray[srcs[r]] for r in refs])), T(scene["K"]),
        T(scene["Rs"][refs]), T(scene["ts"][refs]),
        T(np.stack([scene["Rs"][srcs[r]] for r in refs])),
        T(np.stack([scene["ts"][srcs[r]] for r in refs])), T(dr),
        generators=gens, num_iterations=2, patch=7,
    )
    single = tpm.patchmatch_depth(
        T(gray[1]), T(gray[srcs[1]]), T(scene["K"]), T(scene["Rs"][1]), T(scene["ts"][1]),
        T(scene["Rs"][srcs[1]]), T(scene["ts"][srcs[1]]), T(dr[0]),
        generator=torch.Generator().manual_seed(3), num_iterations=2, patch=7,
    )
    np.testing.assert_allclose(out.depth[0].numpy(), single.depth.numpy(), rtol=1e-5)


def test_select_source_views_gates_and_matches_jax():
    ids = list(range(6))
    poses = {}
    for i in ids:
        th = (i - 2.5) * 0.3
        C = np.array([4 * np.sin(th), 0.0, -4 * np.cos(th)])
        z = -C / np.linalg.norm(C)
        x = np.cross([0, -1, 0], z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        poses[i] = (R, -R @ C)
    out = tpm.select_source_views(ids, poses, np.zeros(3), k=3)
    assert set(out.keys()) == set(ids)
    for i, js in out.items():
        assert len(js) == 3 and i not in js
    assert out == jpm.select_source_views(ids, poses, np.zeros(3), k=3)


def test_full_mvs_reconstructor_matches_jax_gates_and_count(scene):
    kw = dict(scale=1.0, num_iterations=4, patch_size=7, min_views=3, voxel_size=0.01)
    poses = {i: (scene["Rs"][i], scene["ts"][i]) for i in range(5)}
    sparse = sparse_from_depth(scene, per_view=300, views=[2])
    points, colors = tpm.PatchMatchMVS(
        Camera.from_matrix(scene["K"]), PatchMatchConfig(**kw), device="cpu"
    ).reconstruct(scene["images"], poses, sparse_points=sparse)
    assert len(points) > 3000
    assert colors.shape == points.shape and colors.dtype == np.uint8
    med, frac = surface_gate(points)
    assert med < 0.1, f"median point-to-surface distance {med:.3f}"
    assert frac > 0.6
    jpts, _ = jpm.PatchMatchMVS(
        JaxCamera.from_matrix(scene["K"]), JaxPatchMatchConfig(**kw)
    ).reconstruct(scene["images"], poses, sparse_points=sparse)
    assert 0.8 <= len(points) / len(jpts) <= 1.25, (len(points), len(jpts))


def test_fusion_helpers_match_jax_exactly(rng):
    V, H, W = 3, 12, 16
    depth = (2.0 + rng.random((V, H, W))).astype(np.float32)
    conf = rng.integers(0, 5, (V, H, W))
    K = np.array([[20.0, 0, 7.5], [0, 21.0, 5.5], [0, 0, 1]], np.float32)
    Rs = np.stack([np.linalg.qr(rng.standard_normal((3, 3)))[0] for _ in range(V)]).astype(np.float32)
    ts = rng.standard_normal((V, 3)).astype(np.float32)
    pj, mj = jps._fuse_program()(jnp.asarray(depth), jnp.asarray(K), jnp.asarray(Rs),
                                 jnp.asarray(ts), jnp.asarray(conf >= 3))
    pt, mt = tps.backproject_depth(T(depth), T(K), T(Rs), T(ts), torch.from_numpy(conf >= 3))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)  # |X| ~ 5, f32
    a_pts, a_idx = jps.fused_points_compact(pj, mj, lo=16)
    b_pts, b_idx = tps.fused_points_compact(pt, mt)
    np.testing.assert_array_equal(b_idx, a_idx)
    np.testing.assert_allclose(b_pts, a_pts, atol=1e-5)
    Rl, tl = list(Rs), list(ts)
    assert tps.depth_range_from_poses(Rl, tl) == jps.depth_range_from_poses(Rl, tl)
    pts = rng.standard_normal((50, 3)) + [0, 0, 6]
    assert (tps.depth_range_from_sparse(pts, Rs[0], ts[0])
            == jps.depth_range_from_sparse(pts, Rs[0], ts[0]))
