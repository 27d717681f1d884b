"""Sparse bundle adjustment: Schur-reduced Levenberg-Marquardt with CG.

PyTorch port of the single-device part of recon3d_tpu/sfm/bundle.py:

  - per-observation (2, 6)/(2, 3) Jacobian blocks, written out (the JAX
    function takes them by forward-mode autodiff),
  - point blocks eliminated analytically (batched closed-form 3x3
    inverses) and preconditioned CG on the Schur-reduced camera system
    ("Bundle Adjustment in the Large", reduced camera system),
  - every J/J^T contraction is summed over contiguous segments of rows (a
    point's rows, or a camera's after a sort), whose order of summation is
    fixed on any device (a scatter-add's is not),
  - Huber robustification via IRLS weights,
  - cameras parameterized as se(3) increments on the linearization point,
  - gauge fixed by freezing camera 0 (and the scale by damping).

An LM step runs on the table's device: a table on the card takes the
hand-written kernels of csrc/bundle.cu (`_lm_step_kernels`; each product
formed in registers and summed by walking only its segment's rows), any
other the plain version (`_lm_step_plain`: gathers, einsums and cumsum
segment reductions, the kernels' arithmetic written in torch ops). A step
on the kernels counts `ba.kernel_steps`; `kernels/bundle.py::counts`
counts their launches.

Everything is fixed-shape: observations are padded to capacity with
weights. Two entry points: `bundle_adjust_log`, over the pipeline's
append-only observation log, and `bundle_adjust`, over per-point
observation lists. With a mesh (parallel/mesh.py) the observation table
shards over its 'data' axis: each rank holds a contiguous slice with its
own segment indices, the parameters are replicated, and every reduction
over observations is an all_reduce (recon3d_tpu/sfm/bundle.py:100-130,
406-505); accept and reject come from all-reduced costs, so every rank
takes the same step.

The LM loop's condition lives on the device, so each LM iteration costs one
host read (at most `max_iterations` accepted steps a call); the CG inside
an iteration reads nothing back. A call's host table, upload, solve (one
`ba.lm_step` span a step) and fetch are spans (runtime/profiling.py), and
it counts `ba.calls`, `ba.lm_steps` and `ba.lm_accepted`.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.config import BundleConfig
from recon3d_tpu_torch.kernels import bundle as bundle_kernels
from recon3d_tpu_torch.ops.lie import se3_exp
from recon3d_tpu_torch.ops.linalg import einsum_hp, matmul_hp
from recon3d_tpu_torch.ops.pnp import pinhole_jacobian, twist_jacobian
from recon3d_tpu_torch.runtime.device import resolve_device
from recon3d_tpu_torch.runtime.profiling import count, pull, span


class BAData(NamedTuple):
    K: torch.Tensor        # (3, 3)
    R0: torch.Tensor       # (C, 3, 3) linearization poses
    t0: torch.Tensor       # (C, 3)
    X0: torch.Tensor       # (P, 3) linearization points
    obs_cam: torch.Tensor  # (O,) int64
    obs_pt: torch.Tensor   # (O,) int64, sorted ascending over the real rows
    obs_xy: torch.Tensor   # (O, 2)
    obs_w: torch.Tensor    # (O,) 0/1 validity
    # Segment-reduction indices: every J^T contraction sums contiguous
    # segments of rows (the plain version by a cumsum and boundary
    # differences). Points are contiguous because the observation table is
    # point-major, and row o of point p's segment has obs_pt[o] == p;
    # cameras get a sort permutation, whose segments hold only rows inside
    # point segments.
    pt_start: torch.Tensor   # (P,) int64, [start, end) rows of point p
    pt_end: torch.Tensor     # (P,) int64
    cam_perm: torch.Tensor   # (O,) int64, permutation sorting rows by camera
    cam_start: torch.Tensor  # (C,) int64
    cam_end: torch.Tensor    # (C,) int64


class BAParams(NamedTuple):
    xi: torch.Tensor       # (C, 6) se3 increments
    dX: torch.Tensor       # (P, 3) point increments


def _apply_increment(xi, R0, t0):
    dR, dt = se3_exp(xi)
    R = matmul_hp(dR, R0)
    t = einsum_hp("cij,cj->ci", dR, t0) + dt
    return R, t


def _residuals(params: BAParams, data: BAData, robust_w: torch.Tensor) -> torch.Tensor:
    """Weighted residual vector (O*2,)."""
    R, t = _apply_increment(params.xi, data.R0, data.t0)
    X = data.X0 + params.dX
    Xc = einsum_hp("oij,oj->oi", R[data.obs_cam], X[data.obs_pt]) + t[data.obs_cam]
    z = Xc[:, 2:3]
    z = torch.where(z.abs() < 1e-6, torch.where(z < 0, -1e-6, 1e-6), z)
    uv = Xc[:, :2] / z
    K = data.K
    u = K[0, 0] * uv[:, 0] + K[0, 1] * uv[:, 1] + K[0, 2]
    v = K[1, 1] * uv[:, 1] + K[1, 2]
    r = torch.stack([u, v], dim=1) - data.obs_xy
    w = (data.obs_w * robust_w)[:, None]
    return (r * w).reshape(-1)


def _robust_weights(params: BAParams, data: BAData, delta) -> torch.Tensor:
    """IRLS Huber weights sqrt(w(||r||)) from the current residuals."""
    r = _residuals(params, data, torch.ones_like(data.obs_w)).reshape(-1, 2)
    n = torch.linalg.norm(r, dim=1)
    w = torch.where(n <= delta, 1.0, delta / n.clamp_min(1e-12))
    return torch.sqrt(w)


def _reduce_contiguous(y: torch.Tensor, start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """Segment sums of y (O, ...) whose segments occupy contiguous row
    ranges [start_s, end_s): exclusive cumsum + two boundary gathers. Rows
    outside every segment (zero-weight padding) contribute nothing as long
    as their values are zero, which the w-multiplied Jacobians are.

    The scan runs along the last axis of the transposed (D, O) table: a
    CUDA cumsum along the first axis of a tall (O, D) tensor walks its O
    rows one after another."""
    flat = y.reshape(y.shape[0], -1).t().contiguous()                  # (D, O)
    c = torch.cumsum(flat, dim=1)
    c = torch.cat([torch.zeros_like(c[:, :1]), c], dim=1)
    return (c[:, end] - c[:, start]).t().reshape((end.shape[0],) + y.shape[1:])


def _reduce_pt(data: BAData, y: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum per-observation rows into point rows (the table is point-major);
    with a mesh, the shards' sums are added over its 'data' axis."""
    out = _reduce_contiguous(y, data.pt_start, data.pt_end)
    return out if mesh is None else mesh.all_reduce_(out)


def _reduce_cam(data: BAData, y: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum per-observation rows into camera rows via the sort permutation."""
    out = _reduce_contiguous(y[data.cam_perm], data.cam_start, data.cam_end)
    return out if mesh is None else mesh.all_reduce_(out)


def _sum_scalar(x: torch.Tensor, mesh=None) -> torch.Tensor:
    s = x.sum()
    if mesh is None:
        return s
    return mesh.all_reduce_(s.reshape(1))[0]


def _per_obs_jacobians(data: BAData, robust_w: torch.Tensor):
    """Per-observation residuals and Jacobian blocks at the linearization
    point (xi = 0, dX = 0), which is where the LM loop always stands.

    Returns (r (O, 2), Jc (O, 2, 6), Jp (O, 2, 3)): the explicit
    Gauss-Newton blocks every J/J^T application contracts against, so the
    CG loop needs only gathers, einsums and contiguous reductions."""
    Rg = data.R0[data.obs_cam]
    Xc = einsum_hp("oij,oj->oi", Rg, data.X0[data.obs_pt]) + data.t0[data.obs_cam]
    px, Dp = pinhole_jacobian(data.K, Xc, 1e-6)
    w = (data.obs_w * robust_w)[:, None]
    r = (px - data.obs_xy) * w
    Dp = Dp * w[..., None]
    return r, matmul_hp(Dp, twist_jacobian(Xc)), matmul_hp(Dp, Rg)


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    Cc = d * h - e * g
    det = a * A + b * B + c * Cc
    det = torch.where(det.abs() < 1e-18, 1e-18, det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([Cc, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def _lm_step(
    data: BAData,
    damping,
    delta,
    cg_iters: int = 40,
    motion_only: bool = False,
    mesh=None,
):
    """One LM iteration from the linearization point of `data` via the
    Schur-reduced camera system: eliminate all point blocks analytically
    (their damped 3x3 Hessians invert in closed form), run preconditioned
    CG on the 6C-dim camera system, back-substitute the point step.
    Returns (cand BAParams, cost0, cost1).

    (The JAX function also takes the parameters to step from; its callers
    always pass zeros, and the blocks here are written out at zero.)

      - the Jacobian is materialized once per LM step as per-observation
        (2, 6)/(2, 3) blocks; every Schur matvec sums per-observation
        products over contiguous segments of rows,
      - the CG space drops from 6C+3P to 6C (P >> C in SfM) and its
        conditioning improves enough that the same iteration budget
        converges,
      - motion_only is the same program with C^{-1} = 0 (points frozen),
      - with a mesh, `data` is this rank's slice of the observations and
        every reduction over observations is summed over the mesh's 'data'
        axis; the camera-sized CG vectors are replicated.

    A table on the card runs `_lm_step_kernels`, any other device the
    plain version, `_lm_step_plain`."""
    if data.X0.device.type == "cuda":
        with torch.cuda.device(data.X0.device):
            return _lm_step_kernels(data, damping, delta, cg_iters, motion_only, mesh)
    return _lm_step_plain(data, damping, delta, cg_iters, motion_only, mesh)


def _lm_step_plain(data: BAData, damping, delta, cg_iters: int = 40, motion_only: bool = False,
                   mesh=None):
    """The plain version of `_lm_step` in torch ops, on any device: gathers,
    einsums and cumsum segment reductions over the whole table."""
    C = data.R0.shape[0]
    P = data.X0.shape[0]
    dt, dev = data.X0.dtype, data.X0.device
    zero = BAParams(xi=torch.zeros((C, 6), dtype=dt, device=dev),
                    dX=torch.zeros((P, 3), dtype=dt, device=dev))
    robust_w = _robust_weights(zero, data, delta)

    fc6 = torch.ones((C, 6), dtype=dt, device=dev)
    fc6[0] = 0.0  # gauge: camera 0 fixed

    r0_obs, Jc, Jp = _per_obs_jacobians(data, robust_w)
    cost0 = 0.5 * _sum_scalar(r0_obs * r0_obs, mesh)

    # gradient halves
    g_c = _reduce_cam(data, einsum_hp("oij,oi->oj", Jc, r0_obs), mesh) * fc6   # (C, 6)
    g_p = _reduce_pt(data, einsum_hp("oij,oi->oj", Jp, r0_obs), mesh)          # (P, 3)

    # per-point damped Hessian blocks and their closed-form inverses
    Cp = _reduce_pt(data, einsum_hp("oia,oib->oab", Jp, Jp), mesh)       # (P, 3, 3)
    diag_p = torch.diagonal(Cp, dim1=-2, dim2=-1)
    Cp = Cp + damping * torch.diag_embed(diag_p) + 1e-8 * torch.eye(3, dtype=dt, device=dev)
    Cinv = torch.zeros_like(Cp) if motion_only else _inv3x3(Cp)

    diag_c = _reduce_cam(data, einsum_hp("oia,oia->oa", Jc, Jc), mesh) * fc6
    lam_c = damping * diag_c + 1e-8                                      # (C, 6)

    def B_apply(xc):  # camera-camera block (undamped)
        u = einsum_hp("oij,oj->oi", Jc, xc[data.obs_cam])
        return _reduce_cam(data, einsum_hp("oij,oi->oj", Jc, u), mesh)

    def E_apply(xp):  # camera <- point coupling
        u = einsum_hp("oij,oj->oi", Jp, xp[data.obs_pt])
        return _reduce_cam(data, einsum_hp("oij,oi->oj", Jc, u), mesh)

    def Et_apply(xc):  # point <- camera coupling
        u = einsum_hp("oij,oj->oi", Jc, xc[data.obs_cam])
        return _reduce_pt(data, einsum_hp("oij,oi->oj", Jp, u), mesh)

    def S_apply(xc):  # Schur complement: B + lam - E Cinv E^T
        xc = xc * fc6
        y = B_apply(xc) + lam_c * xc
        t = einsum_hp("pab,pb->pa", Cinv, Et_apply(xc))
        return (y - E_apply(t)) * fc6

    # RHS: v - E Cinv w with v = -g_c, w = -g_p
    w_p = einsum_hp("pab,pb->pa", Cinv, -g_p)
    b = (-g_c - E_apply(w_p)) * fc6

    # Block-Jacobi preconditioner on the exact 6x6 diagonal blocks of the
    # Schur complement (Ceres' SCHUR_JACOBI): each (camera, point) pair
    # occupies exactly one observation row, so S_cc = sum_o Jc^T Jc + lam -
    # sum_o (Jc^T Jp) Cinv (Jp^T Jc) assembles per observation and reduces
    # over the camera segments. A scalar Jacobi preconditioner needs
    # O(graph diameter) CG iterations on chain-shaped capture arcs.
    E_o = einsum_hp("oia,oib->oab", Jc, Jp)                              # (O, 6, 3)
    Cinv_o = Cinv[data.obs_pt]                                           # (O, 3, 3)
    ECE_o = einsum_hp("oab,obc,odc->oad", E_o, Cinv_o, E_o)              # (O, 6, 6)
    B_o = einsum_hp("oia,oib->oab", Jc, Jc)
    S_blk = _reduce_cam(data, (B_o - ECE_o).reshape(-1, 36), mesh).reshape(C, 6, 6)
    S_blk = S_blk + torch.diag_embed(lam_c)
    # Gauge-fixed and observation-free cameras: their CG coordinates must
    # stay exactly zero; an identity block keeps the inverse benign there.
    live = (fc6[:, 0] > 0) & (diag_c.sum(dim=-1) > 0)
    S_blk = torch.where(live[:, None, None], S_blk, torch.eye(6, dtype=dt, device=dev))
    M_blk = torch.linalg.inv_ex(S_blk)[0]                                # (C, 6, 6)

    def M_apply(r):
        return einsum_hp("cab,cb->ca", M_blk, r) * fc6

    x = torch.zeros_like(b)
    r = b
    z = M_apply(b)
    p = z
    for _ in range(cg_iters):
        Ap = S_apply(p)
        rz = (r * z).sum()
        alpha = rz / (p * Ap).sum().clamp_min(1e-12)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_apply(r)
        beta = (r * z).sum() / rz.clamp_min(1e-12)
        p = z + beta * p
    dc = x * fc6

    # back-substitute the point step: dp = Cinv (w - E^T dc)
    dp = einsum_hp("pab,pb->pa", Cinv, -g_p - Et_apply(dc))

    cand = BAParams(xi=dc, dX=dp)
    r1 = _residuals(cand, data, robust_w)
    cost1 = 0.5 * _sum_scalar(r1 * r1, mesh)
    return cand, cost0, cost1


def _lm_step_kernels(data: BAData, damping, delta, cg_iters: int, motion_only: bool, mesh=None):
    """`_lm_step` on the card: the same arithmetic in the kernels of
    csrc/bundle.cu, launched on the current stream with no host read. With
    a mesh, each partial sum over this rank's rows (the points' and the
    cameras' setup sums, each CG iteration's point sums s and camera sums
    y, the back-substitution's s and the candidate's residuals) is added
    over the 'data' axis before the next launch reads it."""
    if not isinstance(damping, torch.Tensor):
        damping = torch.full((), float(damping), dtype=torch.float32, device=data.X0.device)
    step = bundle_kernels.Step(data, damping, delta, motion_only)

    def reduce(t):
        if mesh is not None:
            mesh.all_reduce_(t)

    step.linearize()
    reduce(step.psum)
    step.point_setup()
    step.cam_setup()
    reduce(step.csum)
    step.cg_init()
    for _ in range(cg_iters):
        step.point_pass(step.p)
        reduce(step.s)
        step.cam_pass()
        reduce(step.y)
        step.cg_update()
    step.point_pass(step.x)          # back-substitution: dX = Cinv (-g_p - E^T x)
    reduce(step.s)
    step.point_update()
    R, t = _apply_increment(step.x, data.R0, data.t0)
    step.cost(R, t)
    reduce(step.rr)
    step.half_sum()
    count("ba.kernel_steps")
    return BAParams(xi=step.x, dX=step.dX), step.scal[0], step.scal[2]


def _lm_loop(
    data: BAData,
    damping0,
    delta,
    max_iters: int = 20,
    cg_iters: int = 40,
    motion_only: bool = False,
    mesh=None,
):
    """Full LM optimization (accept/reject + damping schedule). Returns
    (R, t, X, accepted_iterations). Only accepted steps count towards
    max_iters; a run of rejections ends through the damping bound. With a
    mesh (see _lm_step) every rank runs this loop on its slice."""
    R0, t0, X0 = data.R0, data.t0, data.X0
    damping = torch.full((), damping0, dtype=X0.dtype, device=X0.device)
    it = 0
    while it < max_iters:
        with span("ba.lm_step"):
            cand, cost0, cost1 = _lm_step(
                data._replace(R0=R0, t0=t0, X0=X0), damping, delta,
                cg_iters=cg_iters, motion_only=motion_only, mesh=mesh,
            )
            accept = cost1 < cost0
            Rn, tn = _apply_increment(cand.xi, R0, t0)
            R0 = torch.where(accept, Rn, R0)
            t0 = torch.where(accept, tn, t0)
            X0 = torch.where(accept, X0 + cand.dX, X0)
            converged = accept & ((cost0 - cost1) / cost0.clamp_min(1e-12) < 1e-5)
            diverged = ~accept & (damping > 1e4)
            damping = torch.where(accept, (damping * 0.5).clamp_min(1e-8), damping * 4.0)
            # the one host read of the iteration
            accepted, done = pull(torch.stack([accept, converged | diverged])).tolist()
            count("ba.lm_steps")
            count("ba.lm_accepted", int(accepted))
        it += int(accepted)
        if done:
            break
    return R0, t0, X0, it


def _cam_segments(obs_cam, obs_w, C: int):
    """(cam_perm, cam_start, cam_end) of a table's rows: a stable sort by
    camera, where zero-weight rows take key C and sort behind every
    camera's segment (they add nothing anywhere)."""
    cam_key = torch.where(obs_w > 0, obs_cam, C)
    cam_perm = torch.argsort(cam_key, stable=True)
    cam_sorted = cam_key[cam_perm]
    cams = torch.arange(C, device=obs_cam.device)
    return (cam_perm, torch.searchsorted(cam_sorted, cams, side="left"),
            torch.searchsorted(cam_sorted, cams, side="right"))


def _obs_table(
    K, R0, t0, X0,
    log_cam, log_pid, log_xy,  # (cap,) raw camera ids / (cap,) point ids / (cap, 2)
    n_obs: int,                # valid log rows
    row_of,                    # (S,): camera id -> camera row, -1 absent
) -> BAData:
    """BAData of the raw arrival-order log, built on the device."""
    cap = log_cam.shape[0]
    C = R0.shape[0]
    P = X0.shape[0]
    dev = X0.device
    rows = row_of[log_cam.clamp(0, row_of.shape[0] - 1)]
    valid = (
        (torch.arange(cap, device=dev) < n_obs) & (rows >= 0) & (log_cam >= 0)
        & (log_pid >= 0) & (log_pid < P)
    )
    # point-major reorder: invalid and padded rows get key P and sort last,
    # outside every [pt_start, pt_end) segment
    sort_key = torch.where(valid, log_pid, P)
    perm = torch.argsort(sort_key, stable=True)
    obs_pt_key = sort_key[perm]
    obs_cam = torch.where(valid, rows, 0)[perm]
    obs_w = valid[perm].to(X0.dtype)
    pts = torch.arange(P, device=dev)
    cam_perm, cam_start, cam_end = _cam_segments(obs_cam, obs_w, C)
    return BAData(
        K=K, R0=R0, t0=t0, X0=X0,
        obs_cam=obs_cam, obs_pt=obs_pt_key.clamp_max(P - 1),
        obs_xy=log_xy[perm], obs_w=obs_w,
        pt_start=torch.searchsorted(obs_pt_key, pts, side="left"),
        pt_end=torch.searchsorted(obs_pt_key, pts, side="right"),
        cam_perm=cam_perm, cam_start=cam_start, cam_end=cam_end,
    )


def _table_rows(data: BAData, lo: int, hi: int) -> BAData:
    """Rows [lo, hi) of a point-major table as a table of their own (one
    shard of a mesh, recon3d_tpu/sfm/bundle.py:477-505): the point bounds
    clipped into the slice, the camera sort redone over its rows."""
    obs_cam, obs_w = data.obs_cam[lo:hi], data.obs_w[lo:hi]
    cam_perm, cam_start, cam_end = _cam_segments(obs_cam, obs_w, data.R0.shape[0])
    return data._replace(
        obs_cam=obs_cam, obs_pt=data.obs_pt[lo:hi], obs_xy=data.obs_xy[lo:hi], obs_w=obs_w,
        pt_start=data.pt_start.clamp(lo, hi) - lo, pt_end=data.pt_end.clamp(lo, hi) - lo,
        cam_perm=cam_perm, cam_start=cam_start, cam_end=cam_end)


def _solve_table(data: BAData, damping0, delta, max_iters: int, cg_iters: int = 24,
                 motion_only: bool = False, mesh=None):
    """The LM loop over a table (with a mesh: this rank's shard). Returns
    (R, t, X, iters, rms_before, rms_after, n_used)."""
    C, P = data.R0.shape[0], data.X0.shape[0]
    dev = data.X0.device
    params = BAParams(xi=torch.zeros((C, 6), dtype=data.X0.dtype, device=dev),
                      dX=torch.zeros((P, 3), dtype=data.X0.dtype, device=dev))
    ones = torch.ones_like(data.obs_w)
    n_used = _sum_scalar(data.obs_w, mesh).clamp_min(1.0)
    rms0 = torch.sqrt(_sum_scalar(_residuals(params, data, ones) ** 2, mesh) / n_used)
    R_f, t_f, X_f, iters = _lm_loop(
        data, damping0, delta, max_iters, cg_iters=cg_iters, motion_only=motion_only,
        mesh=mesh)
    d_fin = data._replace(R0=R_f, t0=t_f, X0=X_f)
    rms1 = torch.sqrt(_sum_scalar(_residuals(params, d_fin, ones) ** 2, mesh) / n_used)
    return R_f, t_f, X_f, iters, rms0, rms1, n_used


def _bucket(n: int, lo: int) -> int:
    c = lo
    while c < n:
        c *= 4
    return c


def kp_table_of(kp_xy) -> Tuple[np.ndarray, np.ndarray]:
    """(kp_flat (sum N, 2) float32, kp_off (V+1,) int64) of per-view tables."""
    kp_off = np.zeros(len(kp_xy) + 1, np.int64)
    np.cumsum(np.fromiter((len(k) for k in kp_xy), np.int64, count=len(kp_xy)),
              out=kp_off[1:])
    kp_flat = (np.concatenate([np.asarray(k, np.float32).reshape(-1, 2) for k in kp_xy])
               if kp_xy else np.zeros((0, 2), np.float32))
    return kp_flat, kp_off


def bundle_adjust(
    K: np.ndarray,
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]],
    points: np.ndarray,
    observations: List[List[Tuple[int, int]]],
    kp_xy: List[np.ndarray],
    config: Optional[BundleConfig] = None,
    size_hint: Optional[Tuple[int, int, int]] = None,
    max_iterations: Optional[int] = None,
    kp_table: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    device="cuda",
    mesh=None,
):
    """Bundle adjustment of per-point observation lists, on one device or
    sharded over a mesh's 'data' axis (mesh=, recon3d_tpu/sfm/bundle.py:
    625-626,700-712).

    observations[p] = [(cam_id, kp_id), ...]; kp_xy[cam] = (N, 2) pixels;
    kp_table: optional precomputed (kp_flat, kp_off) concatenation of
    kp_xy. Flattens the lists into a (pid, cam_id, kp_id) log, dropping
    observations of cameras absent from `poses`, and solves it with
    `bundle_adjust_log`. Returns (new_poses, new_points, stats)."""
    counts = np.fromiter((len(o) for o in observations), np.int64, count=len(observations))
    O_all = int(counts.sum())
    flat = np.fromiter(
        itertools.chain.from_iterable(itertools.chain.from_iterable(observations)),
        np.int64, count=2 * O_all,
    ).reshape(-1, 2)
    keep = np.isin(flat[:, 0], np.fromiter(poses, np.int64, count=len(poses)))
    cams, kps = flat[keep, 0], flat[keep, 1]
    kp_table = kp_table if kp_table is not None else kp_table_of(kp_xy)
    if not ((kps >= 0).all() and (kps < np.diff(kp_table[1])[cams]).all()):
        raise ValueError("observation keypoint id out of range for its camera")
    pids = np.repeat(np.arange(len(observations), dtype=np.int64), counts)[keep]
    obs_log = np.stack([pids, cams, kps], axis=1)
    return bundle_adjust_log(K, poses, points, obs_log, kp_table, config, size_hint,
                             max_iterations, device=device, mesh=mesh)


def bundle_adjust_log(
    K: np.ndarray,
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]],
    points: np.ndarray,
    obs_log: np.ndarray,
    kp_table: Tuple[np.ndarray, np.ndarray],
    config: Optional[BundleConfig] = None,
    size_hint: Optional[Tuple[int, int, int]] = None,
    max_iterations: Optional[int] = None,
    device_cache: Optional[dict] = None,
    device="cuda",
    mesh=None,
):
    """Bundle adjustment over an APPEND-ONLY observation log (one device,
    or sharded over `mesh`'s 'data' axis, where device_cache is unused).

    obs_log: (O, 3) int32 rows (pid, cam_id, kp_id) in arrival order: the
    pipeline appends a row whenever it records an observation. The padded
    log lives on the device between calls (device_cache, mutated in place);
    only rows added since the previous call are uploaded. Sizes are padded
    to x4 buckets (size_hint predicts the final ones), so that the cached
    log keeps its capacity while the reconstruction grows; the padded rows
    have weight zero and change no sum.

    poses: {cam_id: (R, t)}; points: (P, 3); kp_table: (kp_flat (sumK, 2),
    kp_off (V+1,)). Returns (new_poses, new_points, stats)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    config = config or BundleConfig()
    hC, hP, hO = size_hint or (0, 0, 0)
    cam_ids = sorted(poses.keys())
    cam_row = {c: i for i, c in enumerate(cam_ids)}
    nC = len(cam_ids)
    nP = len(points)
    O = int(len(obs_log))
    if nC < 2 or nP < 8 or O == 0:
        return poses, points, {"iterations": 0}
    count("ba.calls")

    with span("ba.prep"):
        C = _bucket(max(nC, hC), 4)
        P = _bucket(max(nP, hP), 256)
        cap = _bucket(max(O, hO), 256)

        row_need = max(int(obs_log[:, 1].max()), max(cam_ids)) + 1
        row_of = np.full(_bucket(max(row_need, hC), 4), -1, np.int64)
        row_of[np.asarray(cam_ids, np.int64)] = np.arange(nC, dtype=np.int64)
        R0 = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
        t0 = np.zeros((C, 3), np.float32)
        t0[:, 2] = 1.0
        R0[:nC] = np.stack([poses[c][0] for c in cam_ids])
        t0[:nC] = np.stack([poses[c][1] for c in cam_ids])
        X0 = np.zeros((P, 3), np.float32)
        X0[:nP] = points

    kp_flat, kp_off = kp_table
    solve_kw = dict(
        damping0=config.init_damping, delta=config.robust_delta_px,
        max_iters=config.max_iterations if max_iterations is None else max_iterations,
        cg_iters=config.cg_iterations, motion_only=config.motion_only)

    def rows_of(log_rows):
        """(cam, pid, xy) host arrays of log rows."""
        xy = kp_flat[kp_off[log_rows[:, 1]] + log_rows[:, 2]].astype(np.float32)
        return log_rows[:, 1].astype(np.int64), log_rows[:, 0].astype(np.int64), xy

    def padded_log(cap):
        full = (np.zeros(cap, np.int64), np.zeros(cap, np.int64),
                np.zeros((cap, 2), np.float32))
        full[0][:O], full[1][:O], full[2][:O] = rows_of(obs_log[:O])
        return full

    if mesh is not None:
        # every rank builds the table from the same raw log and keeps its
        # contiguous rows; the capacity is rounded up to a multiple of 'data'
        with span("ba.upload"):
            n_data = mesh.shape["data"]
            cap = -(-cap // n_data) * n_data
            per = cap // n_data
            common = dict(K=np.asarray(K, np.float32), R0=R0, t0=t0, X0=X0,
                          log=padded_log(cap), n_obs=O, row_of=row_of, kw=solve_kw)
            payloads = [dict(common, rows=(d * per, (d + 1) * per))
                        for d in map(mesh.data_index_of, range(mesh.world))]
        with span("ba.solve"):
            R_f, t_f, X_f, iters, rms0, rms1, n_used = mesh.call(_ba_shard, payloads)[0]
    else:
        with span("ba.upload"):
            cache = device_cache if device_cache is not None else {}
            cached = cache.get("log")
            if (
                cached is not None and cached["cap"] == cap and cached["count"] <= O
                and cached["cam"].device.type == dev.type
            ):
                have = cached["count"]
                dev_cam, dev_pid, dev_xy = cached["cam"], cached["pid"], cached["xy"]
                if O > have:
                    tc, tp, txy = rows_of(obs_log[have:O])
                    dev_cam[have:O] = torch.from_numpy(tc).to(dev)
                    dev_pid[have:O] = torch.from_numpy(tp).to(dev)
                    dev_xy[have:O] = torch.from_numpy(txy).to(dev)
            else:
                # any cache miss (no cache, another capacity or device, a log
                # that shrank) is a full upload
                dev_cam, dev_pid, dev_xy = (torch.from_numpy(a).to(dev)
                                            for a in padded_log(cap))
            cache["log"] = {"cap": cap, "count": O, "cam": dev_cam, "pid": dev_pid,
                            "xy": dev_xy}

        with span("ba.solve"):
            R_f, t_f, X_f, iters, rms0, rms1, n_used = _solve_table(_obs_table(
                torch.from_numpy(np.asarray(K, np.float32)).to(dev),
                torch.from_numpy(R0).to(dev), torch.from_numpy(t0).to(dev),
                torch.from_numpy(X0).to(dev), dev_cam, dev_pid, dev_xy, O,
                torch.from_numpy(row_of).to(dev)), **solve_kw)
    with span("ba.fetch"):
        R_final = pull(R_f).numpy()
        t_final = pull(t_f).numpy()
        new_poses = {c: (R_final[i], t_final[i]) for c, i in cam_row.items()}
        new_points = pull(X_f).numpy()[:nP]
        stats = {
            "iterations": int(iters),
            "rms_before": float(pull(rms0)), "rms_after": float(pull(rms1)),
            "num_obs": int(pull(n_used)),
        }
    return new_poses, new_points, stats


def _ba_shard(mesh, p: dict):
    """One rank's LM loop over its rows of the observation table; rank 0
    returns (R, t, X, iterations, rms_before, rms_after, n_used)."""
    if mesh.model_index:
        return None

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(mesh.device)

    data = _obs_table(t(p["K"]), t(p["R0"]), t(p["t0"]), t(p["X0"]), *map(t, p["log"]),
                      p["n_obs"], t(p["row_of"]))
    out = _solve_table(_table_rows(data, *p["rows"]), mesh=mesh, **p["kw"])
    return None if mesh.rank else out
