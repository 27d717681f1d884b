"""Global structure-from-motion: rotation and translation averaging.

PyTorch port of recon3d_tpu/sfm/global_sfm.py. Instead of registering
images one wave at a time, every camera rotation is solved at once by
chordal averaging over the pairwise pose graph, every camera centre by a
linear direction-consistency solve, every feature track is triangulated in
one batched masked N-view DLT, and the full sparse bundle adjuster
polishes the result.

On the device, each stage is one batched call:
  - relative poses: all E verified pairs through one recover_pose over
    padded correspondence tables;
  - rotation averaging: a loop of segment sums (index_add_) of 3x3
    products and batched SO(3) projections, no per-camera host loop;
  - track triangulation: one masked N-view DLT over all tracks.
Translation averaging (a 3V x 3V system, V at most a few hundred) and the
track union-find are host numpy, as in the JAX package.

Use: `python -m recon3d_tpu_torch.cli IMAGES --global-sfm`, or
run_global_sfm(pipeline) after load, extract and match. Draws no
randomness of its own (try_recover_images draws from the pipeline's
generator).
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.ops.epipolar import essential_from_fundamental, recover_pose
from recon3d_tpu_torch.ops.linalg import einsum_hp, nearest_rotation
from recon3d_tpu_torch.ops.triangulate import reprojection_errors, triangulate_nview
from recon3d_tpu_torch.runtime.device import resolve_device

_MAX_PAIR_CORR = 512  # correspondences per pair fed to recover_pose
_MAX_TRACK_OBS = 24   # cap per-track observations in the padded DLT table


# -- stage 1: relative poses over the match graph -----------------------------


def relative_poses(pipeline):
    """Two-view geometry of every verified pair, in one batched call.

    Returns numpy (ei, ej, R_rel (E,3,3), t_rel (E,3), w (E,)) with the
    convention x_j = R_rel x_i + t_rel (t unit norm), w = cheirality-inlier
    count, over the pairs whose vote reaches 8."""
    dev = pipeline.device
    K = pipeline.camera.K.to(dev, torch.float32)
    pairs = sorted(pipeline.matches.keys())
    E = len(pairs)
    if E == 0:
        raise RuntimeError("no verified pairs for global SfM")
    P = _MAX_PAIR_CORR
    x1 = np.zeros((E, P, 2), np.float32)
    x2 = np.zeros((E, P, 2), np.float32)
    msk = np.zeros((E, P), np.float32)
    Fs = np.zeros((E, 3, 3), np.float32)
    for e, (i, j) in enumerate(pairs):
        m = pipeline.matches[(i, j)]
        a = pipeline.kp_xy[i][m["idx1"]][:P]
        b = pipeline.kp_xy[j][m["idx2"]][:P]
        x1[e, : len(a)] = a
        x2[e, : len(b)] = b
        msk[e, : len(a)] = 1.0
        Fs[e] = m["F"]

    Es = essential_from_fundamental(pipeline._dev(Fs), K)
    R_rel, t_rel, front = recover_pose(
        Es, pipeline._dev(x1), pipeline._dev(x2), K, pipeline._dev(msk))
    w = front.sum(dim=-1).to(torch.float32).cpu().numpy()
    ei = np.asarray([p[0] for p in pairs], np.int32)
    ej = np.asarray([p[1] for p in pairs], np.int32)
    keep = w >= 8  # pairs whose cheirality vote is too thin are unreliable
    if not keep.any():
        raise RuntimeError(
            "global SfM: no reliable pairs (every two-view cheirality vote "
            "< 8): the scene is too low-parallax or low-texture for pose "
            "averaging; use the incremental pipeline"
        )
    return (
        ei[keep], ej[keep],
        R_rel.cpu().numpy()[keep], t_rel.cpu().numpy()[keep], w[keep],
    )


# -- stage 2: rotation averaging ----------------------------------------------


def _spanning_tree_init(ei, ej, R_rel, w, V) -> Tuple[np.ndarray, np.ndarray]:
    """Compose rotations along a max-weight spanning tree (host BFS)."""
    order = np.argsort(-w)
    adj: Dict[int, List[Tuple[int, int, bool]]] = {v: [] for v in range(V)}
    for e in order:
        i, j = int(ei[e]), int(ej[e])
        adj[i].append((j, e, False))  # R_j = R_rel[e] @ R_i
        adj[j].append((i, e, True))   # R_i = R_rel[e].T @ R_j
    R = np.tile(np.eye(3, dtype=np.float32), (V, 1, 1))
    seen = np.zeros(V, bool)
    deg = np.bincount(ei, minlength=V) + np.bincount(ej, minlength=V)
    root = int(np.argmax(deg))
    seen[root] = True
    stack = [root]
    while stack:
        u = stack.pop()
        for v, e, rev in adj[u]:
            if seen[v]:
                continue
            seen[v] = True
            R[v] = (R_rel[e].T if rev else R_rel[e]) @ R[u]
            stack.append(v)
    return R, seen


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median: the mean of the two middle values of an even-length
    vector (torch.median returns the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def rotation_averaging(ei, ej, R_rel, w, V, iters: int | None = None, device="cuda"):
    """Robust chordal averaging: R_i <- proj_SO3(weighted sum of the
    neighbours' predictions), with Cauchy weights from the edge residuals
    ||R_rel R_i - R_j||_F recomputed every iteration (two-view geometry on
    low-texture or low-parallax pairs gives multi-degree outlier edges that
    plain L2 would average in). Runs on `device` ("cuda" unless the caller
    asks for "cpu"). Returns numpy (R (V,3,3), seen (V,)).

    iters defaults to max(64, V): information flows one graph hop per
    iteration, so a long arc needs about V rounds. Each round is a few
    batched device operations over the edge list; the segment sums are
    index_add_, which sums in another order than jax.ops.segment_sum."""
    if iters is None:
        iters = max(64, V)
    R0, seen = _spanning_tree_init(ei, ej, R_rel, w, V)
    dev = resolve_device(device)
    ei_t = torch.as_tensor(np.asarray(ei, np.int64), device=dev)
    ej_t = torch.as_tensor(np.asarray(ej, np.int64), device=dev)
    Rr = torch.as_tensor(np.asarray(R_rel, np.float32), device=dev)
    w0 = torch.as_tensor((w / max(w.max(), 1e-6)).astype(np.float32), device=dev)
    deg = torch.as_tensor(
        (np.bincount(ei, weights=w, minlength=V)
         + np.bincount(ej, weights=w, minlength=V)) > 0, device=dev)
    R = torch.as_tensor(R0, device=dev)
    for k in range(iters):
        pred_j = einsum_hp("eab,ebc->eac", Rr, R[ei_t])       # for ej
        pred_i = einsum_hp("eba,ebc->eac", Rr, R[ej_t])       # R^T via eba
        resid = torch.linalg.norm((pred_j - R[ej_t]).reshape(len(ei), -1), dim=-1)
        # Cauchy weights around the current consensus scale; the floor keeps
        # well-fitting graphs (resid ~ 0) at full weight. Graduated
        # non-convexity: sigma starts 8x wide and anneals to 1x over the
        # first half of the schedule, so the long-span edges that can unbend
        # an arc the spanning tree composed from adjacent edges pull first.
        kf = np.float32(k)
        anneal = np.float32(1.0) + np.float32(7.0) * np.square(
            np.maximum(np.float32(1.0) - np.float32(2.0) * kf / np.float32(max(iters, 1)),
                       np.float32(0.0)))
        sigma = torch.clamp(_median(resid), min=0.02) * float(anneal)
        wr = (w0 * sigma ** 2 / (sigma ** 2 + resid ** 2))[:, None, None]
        M = torch.zeros((V, 3, 3), dtype=R.dtype, device=dev)
        M.index_add_(0, ej_t, wr * pred_j)
        M.index_add_(0, ei_t, wr * pred_i)
        Rn = nearest_rotation(M)
        R = torch.where(deg[:, None, None], Rn, R)
    # gauge: camera 0 = identity
    R = einsum_hp("vab,cb->vac", R, R[0])
    return R.cpu().numpy(), seen


# -- stage 3: translation averaging -------------------------------------------


def translation_averaging(ei, ej, t_rel, R, w, V) -> np.ndarray:
    """Camera centres from pairwise directions (host float64 linear
    algebra: the system is 3V x 3V with V at most a few hundred).

    Block-coordinate descent on the jointly convex program
    min_{C,s} sum_e w_e ||(C_j - C_i) - s_e d_e||^2 s.t. s_e >= 1, where
    d_e = -R_j^T t_rel (world direction C_i -> C_j). Outlier directions are
    handled upstream (the cheirality-weight gate) and downstream (robust BA
    and the resection rounds), not here."""
    E = len(ei)
    # float64 throughout: the projector Laplacian's informative spectrum
    # reaches ~1e-9 on long chains; float32 direction noise (~1e-7) would
    # mix the near-degenerate lowest eigenvectors.
    d = -np.einsum(
        "eba,eb->ea", R[ej].astype(np.float64), t_rel.astype(np.float64)
    )
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)

    we = w / max(w.max(), 1e-6)

    # Given the per-edge scales s_e, minimising over C is a plain block
    # graph-Laplacian solve; then s_e = max(d_e . (C_j - C_i), 1). Both
    # half-steps are exact minimisations, so the iteration converges to the
    # global optimum: exact data gives the truth scaled so that its smallest
    # edge spacing is 1. L is fixed: prefactor it.
    L = np.zeros((V, V))
    for e in range(E):
        i, j = int(ei[e]), int(ej[e])
        L[i, i] += we[e]
        L[j, j] += we[e]
        L[i, j] -= we[e]
        L[j, i] -= we[e]
    Lr = L[1:, 1:]  # gauge: C_0 = 0
    Lr_inv = np.linalg.inv(Lr + 1e-12 * np.eye(V - 1))
    s = np.ones(E)
    C = np.zeros((V, 3))
    for _ in range(500):
        rhs = np.zeros((V, 3))
        contrib = (we * s)[:, None] * d
        np.add.at(rhs, ej, contrib)
        np.add.at(rhs, ei, -contrib)
        C = np.concatenate([np.zeros((1, 3)), Lr_inv @ rhs[1:]], axis=0)
        proj = np.einsum("ea,ea->e", C[ej] - C[ei], d)
        s_new = np.maximum(proj, 1.0)
        delta = np.max(np.abs(s_new - s)) / max(np.max(s_new), 1e-12)
        s = s_new
        if delta < 1e-12:
            break
    return C


# -- stage 4: tracks ----------------------------------------------------------


def build_tracks(pipeline, max_tracks: int):
    """Constrained union-find over matched keypoints -> tracks
    [(cam, kp), ...].

    A match merges two tracks only when their image sets are disjoint;
    conflicting merges are skipped. Plain union-find followed by
    drop-if-ambiguous lets one bad correspondence glue two long tracks into
    a component with duplicate images that must then be discarded whole;
    constrained merging keeps every clean prefix instead. Pose-graph-only
    (`aux`) matches are skipped."""
    counts = [len(k) for k in pipeline.kp_xy]
    base = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    total = int(base[-1])
    parent = np.arange(total, dtype=np.int64)
    imgset: dict = {}  # root -> set of image ids (created lazily on merge)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for (i, j), m in pipeline.matches.items():
        if m.get("aux"):
            continue  # long-span edges for the pose graph only: their
            # recovered keypoints are too noisy for triangulated tracks
        na = base[i] + np.asarray(m["idx1"], np.int64)
        nb = base[j] + np.asarray(m["idx2"], np.int64)
        for a, b in zip(na.tolist(), nb.tolist()):
            ra, rb = find(a), find(b)
            if ra == rb:
                continue
            sa = imgset.get(ra)
            sb = imgset.get(rb)
            if sa is None:
                sa = {i}  # singleton root: node a is one of image i's kps
            if sb is None:
                sb = {j}
            if sa & sb:
                continue  # conflict: would put two keypoints in one image
            # union by size (set size == component size for matched kps)
            if len(sa) < len(sb):
                ra, rb, sa, sb = rb, ra, sb, sa
            parent[rb] = ra
            sa |= sb
            imgset[ra] = sa
            imgset.pop(rb, None)

    roots = np.array([find(a) for a in range(total)])
    order = np.argsort(roots, kind="stable")
    tracks = []
    img_of = np.searchsorted(base, order, side="right") - 1
    kp_of = order - base[img_of]
    bounds = np.nonzero(np.diff(roots[order]))[0] + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [total]])
    for s, e in zip(starts, ends):
        if e - s < 2:
            continue
        cams = img_of[s:e]
        if len(np.unique(cams)) != e - s:  # unreachable under the invariant
            continue
        tracks.append(list(zip(cams.tolist(), kp_of[s:e].tolist())))
        if len(tracks) >= max_tracks:
            break
    return tracks


# -- orchestration -------------------------------------------------------------


def track_table(pipeline, tracks):
    """Padded (tracks, cam_idx (T, Vmax), xs (T, Vmax, 2), msk (T, Vmax))
    for the batched masked N-view DLT."""
    T = len(tracks)
    Vmax = max(len(tr) for tr in tracks)
    cam_idx = np.zeros((T, Vmax), np.int32)
    xs = np.zeros((T, Vmax, 2), np.float32)
    msk = np.zeros((T, Vmax), np.float32)
    for t, tr in enumerate(tracks):
        for v, (c, k) in enumerate(tr):
            cam_idx[t, v] = c
            xs[t, v] = pipeline.kp_xy[c][k]
            msk[t, v] = 1.0
    return tracks, cam_idx, xs, msk


def run_global_sfm(pipeline) -> None:
    """Solve poses and points globally and write them into the pipeline's
    state (poses, registered, points, observations, kp_to_point, colours),
    so that every later stage (BA, dense, exports, stats) works unchanged."""
    cfg = pipeline.config
    t0 = time.time()
    V = len(pipeline.kp_xy)

    ei, ej, R_rel, t_rel, w = relative_poses(pipeline)
    print(f"[global] {len(ei)} reliable pairs over {V} images")

    R, seen = rotation_averaging(ei, ej, R_rel, w, V, device=pipeline.device)
    C = translation_averaging(ei, ej, t_rel, R, w, V)

    connected = np.zeros(V, bool)
    connected[np.unique(np.concatenate([ei, ej]))] = True
    connected &= seen
    pipeline.poses = {
        int(i): (
            R[i].astype(np.float32),
            (-R[i] @ C[i]).astype(np.float32),
        )
        for i in range(V) if connected[i]
    }
    pipeline.registered = set(pipeline.poses.keys())
    print(f"[global] averaged {len(pipeline.poses)} camera poses "
          f"({time.time() - t0:.1f}s)")

    tracks = build_tracks(pipeline, max_tracks=cfg.sfm.max_points)
    tracks = [[(c, k) for c, k in tr if connected[c]] for tr in tracks]
    tracks = [tr for tr in tracks if len(tr) >= 2]
    # Cap the observations of a track (as COLMAP does): the padded table is
    # (T, Vmax, ...), so one feature seen through most of a large scene
    # would inflate every track's row to its length. Evenly spaced
    # subsampling keeps the camera spread.
    tracks = [
        tr if len(tr) <= _MAX_TRACK_OBS
        else [tr[int(v)] for v in np.linspace(0, len(tr) - 1, _MAX_TRACK_OBS).round()]
        for tr in tracks
    ]
    T = len(tracks)
    if T == 0:
        raise RuntimeError("global SfM: no multi-view tracks")
    table = track_table(pipeline, tracks)

    # Alternate triangulation and refinement with gates that tighten: the
    # averaged poses carry a few degrees of error, and a tight first gate
    # would keep exactly the observations consistent with that error (BA
    # then locks the wrong pose in). The Huber-robust BA absorbs what the
    # loose gate admits; each round re-triangulates and tightens.
    _solve_points(pipeline, table, cfg.sfm.max_reproj_error_px * 6.0)
    print(f"[global] {len(pipeline.points3d)} points from {T} tracks "
          f"({time.time() - t0:.1f}s)")
    # Resection-intersection rounds: motion-only refinement (every camera
    # snaps to the current cloud in one batched call) alternated with
    # re-triangulation, which pulls the averaging errors out of the shallow
    # basin that full LM settles into from this start.
    for _ in range(3):
        pipeline.bundle_adjustment_light()
        _solve_points(pipeline, table, cfg.sfm.max_reproj_error_px * 3.0)
    pipeline.bundle_adjustment_full(final=True)
    _solve_points(pipeline, table, cfg.sfm.max_reproj_error_px * 2.0)
    pipeline.bundle_adjustment_full(final=True)
    pipeline.drop_invalid_observations(cfg.sfm.max_reproj_error_px)
    pipeline.bundle_adjustment_full(final=True)
    # Cameras outside the averaged pose graph (disconnected, or too few
    # cheirality inliers) get a second chance through the incremental
    # machinery: batched PnP against the global points.
    pipeline.failed = set(i for i in range(V) if i not in pipeline.registered)
    if pipeline.failed:
        pipeline.try_recover_images()
        pipeline.bundle_adjustment_full(final=True)
    # Final cheirality and reprojection sweep: the last BA can push a
    # tiny-parallax track behind its cameras (its depth is unconstrained).
    pipeline.drop_invalid_observations(cfg.sfm.max_reproj_error_px)
    pipeline._normalize_reconstruction()


def triangulate_gate(K, P_all, Rs, ts, cam_idx, xs, msk, gate_px: float):
    """One batched masked N-view DLT over all tracks, with the
    per-observation reprojection and cheirality gates. Tensors on one
    device: K (3,3), P_all (V,3,4), Rs (V,3,3), ts (V,3), cam_idx (T,Vmax)
    int64, xs (T,Vmax,2), msk (T,Vmax). Returns (X (T,3), ok (T,Vmax))."""
    Ps = P_all[cam_idx]                       # (T, Vmax, 3, 4)
    X = triangulate_nview(Ps, xs, msk)
    Rg = Rs[cam_idx]
    tg = ts[cam_idx]
    Xv = X[:, None, :].expand(tg.shape)
    e = reprojection_errors(K, Rg, tg, Xv, xs)
    z = (einsum_hp("tvab,tvb->tva", Rg, Xv) + tg)[..., 2]
    ok = (e <= gate_px) & (z > 1e-6) & (msk > 0)
    return X, ok


def _solve_points(pipeline, table, gate_px: float) -> None:
    """Triangulate every track with the current poses (one batched masked
    N-view DLT) and rewrite the pipeline's point and observation state."""
    tracks, cam_idx, xs, msk = table
    V = len(pipeline.kp_xy)
    K = pipeline.camera.K.cpu().numpy().astype(np.float32)
    Rs = np.stack([
        np.asarray(pipeline.poses[i][0]) if i in pipeline.poses
        else np.eye(3, dtype=np.float32)
        for i in range(V)
    ]).astype(np.float32)
    ts = np.stack([
        np.asarray(pipeline.poses[i][1]).reshape(3) if i in pipeline.poses
        else np.float32([0, 0, 1])
        for i in range(V)
    ]).astype(np.float32)
    P_all = (K[None] @ np.concatenate([Rs, ts[:, :, None]], axis=2)).astype(np.float32)

    dv = pipeline._dev
    X, ok_obs = triangulate_gate(
        dv(K), dv(P_all), dv(Rs), dv(ts), dv(cam_idx.astype(np.int64)), dv(xs), dv(msk),
        float(np.float32(gate_px)))
    X = X.cpu().numpy()
    ok_obs = ok_obs.cpu().numpy()
    keep = ok_obs.sum(axis=1) >= 2

    pipeline.points3d = []
    pipeline.point_colors = []
    pipeline.observations = []
    pipeline._obs_generation += 1  # wholesale rewrite: the device log is stale
    pipeline.kp_to_point = [np.full(len(k), -1, np.int64) for k in pipeline.kp_xy]
    # Rebuild the 2D-3D correspondence index from scratch: every assignment
    # goes through _note_kp_link, which hands point ids to unregistered
    # match partners, what try_recover_images' batched PnP reads when it
    # recovers cameras outside the averaged pose graph.
    pipeline.corr = {}
    color_img = pipeline.image_set.color if pipeline.image_set else None
    H = color_img.shape[1] if color_img is not None else 0
    W = color_img.shape[2] if color_img is not None else 0
    for t in np.nonzero(keep)[0]:
        obs = [(int(c), int(k)) for v, (c, k) in enumerate(tracks[t]) if ok_obs[t, v]]
        if len(obs) < 2:
            continue
        pid = len(pipeline._pts)
        for c, k in obs:
            pipeline._note_kp_link(c, k, pid)
        pipeline._pts.append(X[t].astype(np.float32))
        pipeline.observations.append(obs)
        if color_img is not None:
            c0, k0 = obs[0]
            x, y = pipeline.kp_xy[c0][k0]
            xi = min(max(int(round(x)), 0), W - 1)
            yi = min(max(int(round(y)), 0), H - 1)
            pipeline._cols.append((color_img[c0, yi, xi] * 255).astype(np.uint8))
        else:
            pipeline._cols.append(np.full(3, 180, np.uint8))
