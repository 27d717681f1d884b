"""The multi-device checks of chip_smoke.py's multi_device phase and of
tests/test_torch_distributed_cuda.py: each sharded function of the port
against the same function on one device, on one scene, for a given mesh.

numpy and torch only (no jax): chip_smoke.py imports it on a machine
without JAX. On the CPU it rehearses the phase with gloo ranks.

  dense_inputs(scene, n_views, scale)  the PatchMatch / sweep inputs of the
                                       first n_views of a rendered scene
  ba_problem(seed, n_cams, n_points)   a perturbed synthetic BA problem
  check_dense(mesh, inp, device, exact)  PatchMatch, sweep, TSDF
  small_inputs(), check_patchmatch_bound(mesh, inp, device)
                                       PatchMatch at the JAX mesh test's bound
  check_ba(mesh, prob, device, exact)
  check_matching(mesh, feats, pairs, device)  bit for bit
  check_train_step(mesh, device, hw, batch)   two steps: losses, gradients

exact=True (a world of 1) asks for bit-identical results; otherwise the
bounds of the JAX package's mesh tests hold: PatchMatch more than 90% of
pixels within 2e-3 relative depth (on the north-star cut and on
tests/test_distributed_dense.py:78-92's scene, where its confident pixels
also lie within a median 5% of the ground truth: check_patchmatch_bound),
TSDF 1e-5 (tests/test_tsdf_mesh.py:182-183), BA rms 0.05, points 2e-3,
rotations 1e-4, translations 1e-3 (tests/test_bundle.py:161-170). Pair
matching is bit-equal to one device either way.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tests.synthetic import make_scene, random_rotation

PM_KW = dict(num_iterations=3, num_samples=8, patch=11, coarse_factor=4, fine_iterations=1)
SWEEP_KW = dict(num_depths=64, patch=5, ncc_threshold=0.8)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def dense_inputs(scene: dict, n_views: int = 16, scale: float = 0.25, J: int = 4) -> dict:
    """Gray planes of the first n_views at `scale`, each view's J nearest
    views along the arc as its sources, K at scale, the ground-truth depth
    sampled at the scaled pixel centres, and depth ranges from it as
    tests/test_distributed_dense.py makes them (0.7 x its least, 1.4 x its
    largest; the sweep's shared range spans all views')."""
    from recon3d_tpu_torch.io.hostimg import resize_batch_np, rgb_to_gray_np

    imgs = np.asarray(scene["images"][:n_views], np.float32)
    H, W = imgs.shape[1:3]
    h, w = int(H * scale), int(W * scale)
    gray = rgb_to_gray_np(resize_batch_np(imgs, (h, w)))
    K = np.asarray(scene["K"], np.float64).copy()
    f = 1.0 / scale
    S = np.array([[1 / f, 0, 0.5 / f - 0.5], [0, 1 / f, 0.5 / f - 0.5], [0, 0, 1]])
    Ks = (S @ K).astype(np.float32)
    Rs = np.asarray(scene["Rs"][:n_views], np.float32)
    ts = np.asarray(scene["ts"][:n_views], np.float32)
    src = [sorted(range(n_views), key=lambda j: (abs(j - v), j))[1: J + 1]
           for v in range(n_views)]
    ys = np.clip(np.round((np.arange(h) + 0.5) * f - 0.5).astype(int), 0, H - 1)
    xs = np.clip(np.round((np.arange(w) + 0.5) * f - 0.5).astype(int), 0, W - 1)
    gt = np.asarray(scene["depth"][:n_views])[:, ys][:, :, xs]
    ranges = np.float32([[g[g > 0].min() * 0.7, g[g > 0].max() * 1.4] for g in gt])
    return dict(ref=gray, src=np.stack([gray[s] for s in src]), K=Ks, Rs=Rs, ts=ts,
                R_src=np.stack([Rs[s] for s in src]), t_src=np.stack([ts[s] for s in src]),
                ranges=ranges, range=np.float32([ranges[:, 0].min(), ranges[:, 1].max()]),
                gt=gt)


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _agree(a, b, rel):
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-6) < rel).mean())


def _recorded(mesh, launches, name):
    """mesh.record_launches(launches, name), or nothing without a dict."""
    import contextlib

    return contextlib.nullcontext() if launches is None else mesh.record_launches(launches, name)


def small_inputs() -> dict:
    """tests/test_distributed_dense.py's scene and batch: views 1-5 of 6 at
    64x96, each with the first 3 other views as sources, depth ranges from
    the ground truth; PatchMatch at 2 rounds, 7x7 windows."""
    from tests.render import render_views

    scene = render_views(n_views=6, image_size=(64, 96), arc_step=0.12)
    refs = [1, 2, 3, 4, 5]
    gray = scene["images"].mean(-1).astype(np.float32)
    srcs = {r: [j for j in range(6) if j != r][:3] for r in refs}
    gt = scene["depth"]
    return dict(
        ref=gray[refs], src=np.stack([gray[srcs[r]] for r in refs]), K=scene["K"],
        Rs=scene["Rs"][refs], ts=scene["ts"][refs],
        R_src=np.stack([scene["Rs"][srcs[r]] for r in refs]),
        t_src=np.stack([scene["ts"][srcs[r]] for r in refs]),
        ranges=np.float32([[gt[r][gt[r] > 0].min() * 0.7, gt[r][gt[r] > 0].max() * 1.4]
                           for r in refs]),
        gt=gt[refs])


def check_patchmatch_bound(mesh, inp: dict, device, seed: int = 0) -> dict:
    """distributed_patchmatch against one device on tests/test_distributed_
    dense.py's scene, at its bound: more than 90% of pixels within 2e-3
    relative depth, and the confident pixels of both runs within a median
    5% of the ground truth, view by view."""
    from recon3d_tpu_torch.dense.distributed import distributed_patchmatch
    from recon3d_tpu_torch.dense.patchmatch import patchmatch_depth_batch, view_generator

    kw = dict(num_iterations=2, patch=7)
    args = [inp[k] for k in ("ref", "src", "K", "Rs", "ts", "R_src", "t_src", "ranges")]
    V = len(inp["ref"])
    single = patchmatch_depth_batch(
        *[_t(a, device) for a in args],
        generators=[view_generator(seed, v, device) for v in range(V)], **kw)
    d1, c1 = single.depth.cpu().numpy(), single.confidence.cpu().numpy()
    sh = distributed_patchmatch(*args, seed=seed, mesh=mesh, **kw)
    agree = _agree(sh.depth, d1, 2e-3)
    if agree <= 0.9:
        raise AssertionError(f"distributed_patchmatch: {agree:.1%} of pixels within 2e-3")
    for depth, conf in ((sh.depth, sh.confidence), (d1, c1)):
        for v in range(V):
            sel = (conf[v] >= 3) & (inp["gt"][v] > 0)
            if sel.sum() >= 100:
                med = float(np.median(np.abs(depth[v][sel] - inp["gt"][v][sel])
                                      / inp["gt"][v][sel]))
                if med >= 0.05:
                    raise AssertionError(f"PatchMatch view {v}: median error {med:.3f}")
    return {"agree_2e-3": agree}


def check_dense(mesh, inp: dict, device, exact: bool, seed: int = 0,
                launches: dict = None) -> dict:
    """distributed_patchmatch, distributed_plane_sweep and fuse_tsdf(mesh=)
    against patchmatch_depth_batch, sweep_depth_maps and fuse_tsdf on one
    device (the TSDF fuses the one-device PatchMatch maps). Raises on a
    miss; returns the agreements and the seconds of each side. launches:
    receives K1's launches on every rank during each sharded call."""
    from recon3d_tpu_torch.dense.distributed import distributed_patchmatch, distributed_plane_sweep
    from recon3d_tpu_torch.dense.patchmatch import patchmatch_depth_batch, view_generator
    from recon3d_tpu_torch.dense.plane_sweep import sweep_depth_maps
    from recon3d_tpu_torch.dense.tsdf import fuse_tsdf

    out = {}
    V = len(inp["ref"])
    args = [inp[k] for k in ("ref", "src", "K", "Rs", "ts", "R_src", "t_src", "ranges")]

    _sync(device)
    t0 = time.perf_counter()
    single = patchmatch_depth_batch(
        *[_t(a, device) for a in args],
        generators=[view_generator(seed, v, device) for v in range(V)], **PM_KW)
    d1 = single.depth.cpu().numpy()
    c1 = single.confidence.cpu().numpy()
    t1 = time.perf_counter()
    with _recorded(mesh, launches, "patchmatch"):
        sh = distributed_patchmatch(*args, seed=seed, mesh=mesh, **PM_KW)
    t2 = time.perf_counter()
    out["patchmatch_s"] = {"single": t1 - t0, "mesh": t2 - t1}
    if exact:
        for name, a, b in (("depth", sh.depth, d1), ("confidence", sh.confidence, c1)):
            if not np.array_equal(a, b):
                raise AssertionError(f"distributed_patchmatch {name} differs from one device "
                                     f"(max {np.abs(a - b).max()})")
        out["patchmatch_agree_2e-3"] = 1.0
    else:
        out["patchmatch_bit_equal"] = bool(np.array_equal(sh.depth, d1)
                                           and np.array_equal(sh.confidence, c1))
        out["patchmatch_agree_2e-3"] = _agree(sh.depth, d1, 2e-3)
        if out["patchmatch_agree_2e-3"] <= 0.9:
            raise AssertionError(f"distributed_patchmatch: {out['patchmatch_agree_2e-3']:.1%} "
                                 "of pixels within 2e-3 of one device")

    sargs = [inp[k] for k in ("ref", "src", "K", "Rs", "ts", "R_src", "t_src")]
    _sync(device)
    t0 = time.perf_counter()
    sd, sc, _ = (x.cpu().numpy() for x in sweep_depth_maps(
        *[_t(a, device) for a in sargs], _t(inp["range"], device), **SWEEP_KW))
    t1 = time.perf_counter()
    with _recorded(mesh, launches, "plane_sweep"):
        md, mc, _ = distributed_plane_sweep(*sargs, inp["range"], mesh=mesh, **SWEEP_KW)
    t2 = time.perf_counter()
    out["sweep_s"] = {"single": t1 - t0, "mesh": t2 - t1}
    same = np.array_equal(md, sd) and np.array_equal(mc, sc)
    out["sweep_bit_equal"] = bool(same)
    if exact and not same:
        raise AssertionError("distributed_plane_sweep differs from one device")
    if not exact:
        out["sweep_agree_1e-3"] = _agree(md, sd, 1e-3)

    tsdf_kw = dict(resolution=128, min_conf=2.0)
    _sync(device)
    t0 = time.perf_counter()
    v1 = fuse_tsdf(d1, c1.astype(np.float32), inp["K"], inp["Rs"], inp["ts"], device=device,
                   **tsdf_kw)
    t1 = time.perf_counter()
    with _recorded(mesh, launches, "tsdf"):
        v2 = fuse_tsdf(d1, c1.astype(np.float32), inp["K"], inp["Rs"], inp["ts"],
                       device=device, mesh=mesh, **tsdf_kw)
    t2 = time.perf_counter()
    out["tsdf_s"] = {"single": t1 - t0, "mesh": t2 - t1}
    err = max(float(np.abs(v2.tsdf - v1.tsdf).max()), float(np.abs(v2.weight - v1.weight).max()))
    out["tsdf_max_abs_err"] = err
    if (exact and err != 0.0) or err > 1e-5:
        raise AssertionError(f"fuse_tsdf(mesh=): max abs error {err}")
    if float(v1.weight.max()) <= 0:
        raise AssertionError("fuse_tsdf: an empty volume")
    return out


def ba_problem(seed: int = 0, n_cams: int = 16, n_points: int = 2000) -> tuple:
    """tests/test_bundle.py::_perturbed_problem at another size: every point
    seen by every camera, poses and points perturbed."""
    rng = np.random.default_rng(seed)
    scene = make_scene(rng, n_points=n_points, n_cams=n_cams, noise_px=0.3)
    poses = {}
    for i in range(n_cams):
        dR = random_rotation(rng, 0.01) if i > 0 else np.eye(3)
        dt = rng.normal(scale=0.01, size=3) if i > 0 else np.zeros(3)
        poses[i] = ((dR @ scene["Rs"][i]).astype(np.float32),
                    (scene["ts"][i] + dt).astype(np.float32))
    points = (scene["X"] + rng.normal(scale=0.02, size=scene["X"].shape)).astype(np.float32)
    obs = [[(c, p) for c in range(n_cams)] for p in range(n_points)]
    kp_xy = [scene["obs"][c].astype(np.float32) for c in range(n_cams)]
    return scene["K"], poses, points, obs, kp_xy


def check_ba(mesh, prob: tuple, device, exact: bool, max_iterations: int = 10) -> dict:
    from recon3d_tpu_torch.config import BundleConfig
    from recon3d_tpu_torch.sfm.bundle import bundle_adjust

    from recon3d_tpu_torch.runtime.profiling import span

    K, poses, points, obs, kp_xy = prob
    cfg = BundleConfig(max_iterations=max_iterations)

    def solve(**kw):
        # the seconds of the LM solve and the fetch, from the call's spans
        with span("check.ba") as s:
            poses_, points_, stats = bundle_adjust(K, poses, points, obs, kp_xy, cfg,
                                                   device=device, **kw)
        stats["solve_fetch_s"] = s.within("ba.solve") + s.within("ba.fetch")
        return poses_, points_, stats

    sp, spts, ss = solve()
    mp, mpts, ms = solve(mesh=mesh)
    out = {"single": ss, "mesh": ms,
           "points_max_abs_err": float(np.abs(mpts - spts).max()),
           "R_max_abs_err": max(float(np.abs(mp[c][0] - sp[c][0]).max()) for c in sp),
           "t_max_abs_err": max(float(np.abs(mp[c][1] - sp[c][1]).max()) for c in sp)}
    if exact:
        if not (out["points_max_abs_err"] == out["R_max_abs_err"] == out["t_max_abs_err"] == 0.0
                and ms["iterations"] == ss["iterations"]):
            raise AssertionError(f"bundle_adjust(mesh=) differs from one device: {out}")
    elif not (abs(ms["rms_after"] - ss["rms_after"]) < 0.05 and out["points_max_abs_err"] < 2e-3
              and out["R_max_abs_err"] < 1e-4 and out["t_max_abs_err"] < 1e-3):
        raise AssertionError(f"bundle_adjust(mesh=) beyond tests/test_bundle.py's bounds: {out}")
    if ms["rms_after"] >= 0.5:
        raise AssertionError(f"bundle_adjust(mesh=): rms {ms['rms_after']}")
    return out


def _match_fields_equal(a, b) -> dict:
    """Whether two match_pairs_batched results are equal bit for bit (pairs,
    counts, inlier indices, F); the pairs that differ, and F's largest
    difference relative to its norm."""
    differ = sum(not ((s[0], s[1], s[5], s[6]) == (m[0], m[1], m[5], m[6])
                      and all(np.array_equal(s[k], m[k]) for k in (2, 3, 4)))
                 for s, m in zip(a, b))
    f_rel = max(float(np.abs(s[4] - m[4]).max() / max(np.linalg.norm(s[4]), 1e-30))
                for s, m in zip(a, b))
    return {"equal": differ == 0 and len(a) == len(b), "pairs_differing": differ,
            "F_max_rel_err": f_rel}


def check_matching(mesh, feats, pairs, device) -> dict:
    """match_pairs_batched(mesh=) against one device from the same
    generator state: bit for bit (every rank draws the whole chunk's
    uniforms and takes its rows; the matcher's sums do not depend on the
    batch's size), the generator left where one device leaves it."""
    from recon3d_tpu_torch.features import frontend

    g1 = torch.Generator(device=device).manual_seed(11)
    g2 = torch.Generator(device=device).manual_seed(11)
    _sync(device)
    t0 = time.perf_counter()
    single = frontend.match_pairs_batched(feats, pairs, g1)
    t1 = time.perf_counter()
    sharded = frontend.match_pairs_batched(feats, pairs, g2, mesh=mesh)
    t2 = time.perf_counter()
    if not torch.equal(g1.get_state(), g2.get_state()):
        raise AssertionError("match_pairs_batched(mesh=) left the generator elsewhere")
    same = _match_fields_equal(single, sharded)
    if not same["equal"]:
        raise AssertionError(f"match_pairs_batched(mesh=) differs from one device: {same}")
    kept = sum(s[5] >= 16 for s in single)
    if kept < len(pairs) // 2:
        raise AssertionError(f"matching kept {kept} of {len(pairs)} pairs")
    return {"pairs": len(pairs), "kept": kept, **same,
            "seconds": {"single": t1 - t0, "mesh": t2 - t1}}


def check_train_step(mesh, device, hw=(128, 128), batch: int = 8) -> dict:
    """Two make_pair_train_step steps of a full-width SuperPoint on `batch`
    homography pairs each, over the mesh against one device: the first
    step's [loss, det, desc] within 1e-5 relative and its gradients (rank
    0's, after the all_reduce) within GRAD_TOL tensor by tensor; the
    second step's losses, which follow the update, within 5e-3 relative
    (as tests/test_torch_train.py holds later steps)."""
    from recon3d_tpu_torch.neural import train
    from recon3d_tpu_torch.neural.superpoint import SuperPointNet
    from recon3d_tpu_torch.neural.synthetic import make_pair_batch
    from recon3d_tpu_torch.neural.weights import flax_init_
    from tests.torch_train_check import GRAD_TOL, grad_errors

    rng = np.random.default_rng(0)
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in make_pair_batch(rng, batch, hw).items()} for _ in range(2)]
    losses, grads = [], []
    for m in (None, mesh):
        net = flax_init_(SuperPointNet(), torch.Generator().manual_seed(0)).to(device)
        tx = train.Adam(1e-3)
        state = train.TrainState(net, tx.init(net.parameters()), 0)
        step = train.make_pair_train_step(net, tx, mesh=m)
        run = []
        for b in batches:
            run.append(step(state, b)[1].cpu().numpy())
            if len(run) == 1:
                grads.append({n: q.grad.cpu().numpy() for n, q in net.named_parameters()})
        losses.append(np.stack(run))
    rel = np.abs(losses[1] - losses[0]) / np.abs(losses[0])
    errs = grad_errors(grads[1], grads[0])
    worst = max(errs, key=errs.get)
    if not (rel[0].max() <= 1e-5 and rel[1].max() <= 5e-3 and errs[worst] < GRAD_TOL):
        raise AssertionError(f"make_pair_train_step(mesh=): losses {losses[1].tolist()} against "
                             f"{losses[0].tolist()}, gradient {worst} {errs[worst]:.2e} apart")
    return {"losses": losses[0].tolist(), "rel_err": [float(r) for r in rel.max(axis=1)],
            "grad_max_rel_l2": errs[worst]}
