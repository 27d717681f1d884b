"""Nistér 5-point essential matrix solver.

PyTorch port of recon3d_tpu/ops/essential5.py (Nistér, "An efficient
solution to the five-point relative pose problem", PAMI 2004):

- An orthonormal basis (X, Y, Z, W) of the null space of the 5x9 epipolar
  constraint matrix, so that E = x X + y Y + z Z + W. The JAX function
  takes it from a complete QR of Q^T; here it is ops/linalg.py
  null_space_rows, the same Householder QR unrolled over the batch (a
  batched QR on CUDA would go matrix by matrix). Any orthonormal basis of
  that space gives the same set of E's in exact arithmetic; in float32 the
  QR's basis recovers more of them than one turned at random.
- det(E) = 0 and the 9 trace constraints (2 E E^T - tr(E E^T) I) E = 0 are
  trilinear forms in E's 9 entries; their coefficient tensors are computed
  once at import (numpy dict polynomials, copied as they are), so the
  expansion over the 20 cubic monomials of (x, y, z) is a chain of small
  einsums against a (10, 9, 9, 9) constant.
- The 10x20 system reduces by one batched 10x10 solve.
- The degree-10 polynomial in z is solved by Durand-Kerner (Weierstrass)
  iteration in complex64: elementwise complex arithmetic over the
  hypothesis batch with a fixed iteration count and no host reads.

Every sample yields 20 candidate E's with validity flags (the <= 10 true
ones, from two root-finding charts); invalid candidates are replaced by a
dead model whose Sampson residuals are huge, so they lose the RANSAC vote.
All functions take leading batch dimensions (pairs, samples).
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch

from recon3d_tpu_torch.ops.linalg import einsum_hp, matmul_hp, null_space_rows

# Nistér / OpenCV five-point column ordering of the 20 cubic monomials.
_MONO = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]

_DK_ITERS = 60
_DEAD_E = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                   np.float32)  # Sampson num=1, den=0 -> ~1e6 px residual


def _constraint_tensors():
    """Static coefficient tensors of the 10 cubic constraints.

    Each constraint (det(E) and the nine entries of
    (2 E E^T - tr(E E^T) I) E) is a trilinear form in the 9 entries of E:
    P(E) = sum_{abc} c_abc E_a E_b E_c. Precomputing c once (numpy dict
    polynomial arithmetic at import) turns the runtime monomial expansion
    into einsums against a (10, 9, 9, 9) constant.

    Returns (C (10, 9, 9, 9) float64, M (64, 20) float64) where M maps
    products m_i m_j m_k of m = (x, y, z, 1) onto the 20 cubic monomial
    columns of the Nister ordering (_MONO).
    """
    # polynomial over E entries: dict {sorted entry-index tuple: coeff}
    def pmulq(p, q):
        out = {}
        for ka, va in p.items():
            for kb, vb in q.items():
                k = tuple(sorted(ka + kb))
                out[k] = out.get(k, 0.0) + va * vb
        return out

    def padd(p, q, s=1.0):
        out = dict(p)
        for k, v in q.items():
            out[k] = out.get(k, 0.0) + s * v
        return out

    E = [[{(3 * r + c,): 1.0} for c in range(3)] for r in range(3)]
    # det(E)
    def minor(a, b, c, d):
        return padd(pmulq(a, b), pmulq(c, d), -1.0)

    det = padd(
        padd(
            pmulq(E[0][0], minor(E[1][1], E[2][2], E[1][2], E[2][1])),
            pmulq(E[0][1], minor(E[1][0], E[2][2], E[1][2], E[2][0])),
            -1.0,
        ),
        pmulq(E[0][2], minor(E[1][0], E[2][1], E[1][1], E[2][0])),
    )
    eet = [[None] * 3 for _ in range(3)]
    for r in range(3):
        for c in range(3):
            acc = {}
            for k in range(3):
                acc = padd(acc, pmulq(E[r][k], E[c][k]))
            eet[r][c] = acc
    tr = padd(padd(eet[0][0], eet[1][1]), eet[2][2])
    cons = []
    for r in range(3):
        for c in range(3):
            acc = {}
            for k in range(3):
                T_rk = padd(
                    {k2: 2.0 * v for k2, v in eet[r][k].items()},
                    tr if r == k else {}, -1.0,
                )
                acc = padd(acc, pmulq(T_rk, E[k][c]))
            cons.append(acc)

    C = np.zeros((10, 9, 9, 9), np.float64)
    for q, poly in enumerate([det] + cons):
        for key, v in poly.items():
            a, b, c = key  # degree exactly 3
            # symmetrize over the distinct permutations
            perms = {(a, b, c), (a, c, b), (b, a, c),
                     (b, c, a), (c, a, b), (c, b, a)}
            for p in perms:
                C[q][p] += v / len(perms)

    # monomial map: m = (x, y, z, 1); product m_i m_j m_k -> _MONO column
    mono_col = {m: i for i, m in enumerate(_MONO)}
    M = np.zeros((64, 20), np.float64)
    for i in range(4):
        for j in range(4):
            for k in range(4):
                exps = [0, 0, 0]
                for ax in (i, j, k):
                    if ax < 3:
                        exps[ax] += 1
                M[i * 16 + j * 4 + k, mono_col[tuple(exps)]] = 1.0
    return C, M


_C_TENSOR, _MONO_MAP = _constraint_tensors()

# Shift for the root-finding chart: q(v) = p(v + delta). Arbitrary value,
# only needs to avoid being a root of p itself (measure zero); shifting
# keeps a root of p at z = 0 from zeroing q's constant term, which would
# degenerate the reversal chart. _SHIFT_MAT[k, j] = C(j, k) delta^(j-k).
_DELTA = 0.11937766
_SHIFT_MAT = np.array(
    [[(_math.comb(j, k) * _DELTA ** (j - k)) if j >= k else 0.0
      for j in range(11)] for k in range(11)], np.float32,
)


def _conv1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1-D polynomial product over the last axis, ascending coefficients."""
    la, lb = a.shape[-1], b.shape[-1]
    out = torch.zeros(a.shape[:-1] + (la + lb - 1,), dtype=a.dtype, device=a.device)
    for i in range(la):
        out[..., i:i + lb] += a[..., i:i + 1] * b
    return out


def _epipolar_rows(x1n: torch.Tensor, x2n: torch.Tensor) -> torch.Tensor:
    """(..., 5, 9) constraint rows for x2^T E x1 = 0 (row-major vec(E))."""
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    return torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], dim=-1)


def _horner_monic(c: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Monic degree-10 polynomial with real coefficients c (..., 11) at
    complex z (..., R)."""
    acc = torch.ones_like(z)
    for i in range(9, -1, -1):
        acc = acc * z + c[..., i:i + 1]
    return acc


def _dhorner_monic(c: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    acc = torch.full_like(z, 10.0)
    for i in range(9, 0, -1):
        acc = acc * z + i * c[..., i:i + 1]
    return acc


def _dk_roots(c: torch.Tensor) -> torch.Tensor:
    """The 10 complex roots (..., 10) of the monic polynomials c (..., 11):
    _DK_ITERS Durand-Kerner steps from a fixed start, then 6 independent
    Newton steps per root."""
    dev = c.device
    roots0 = torch.from_numpy(
        np.power(np.complex64(0.4 + 0.9j), np.arange(10)).astype(np.complex64)).to(dev)
    eye = torch.eye(10, dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=torch.complex64, device=dev)
    r = roots0.expand(c.shape[:-1] + (10,))
    for _ in range(_DK_ITERS):
        prv = _horner_monic(c, r)
        diff = r[..., :, None] - r[..., None, :]
        denom = torch.where(eye, one, diff).prod(dim=-1)
        r = r - prv / torch.where(denom.abs() > 1e-20, denom, one)
    for _ in range(6):
        dp = _dhorner_monic(c, r)
        r = r - _horner_monic(c, r) / torch.where(dp.abs() > 1e-20, dp, one)
    return r


def _peval(cfs: torch.Tensor, zz: torch.Tensor) -> torch.Tensor:
    """Real polynomial cfs (..., d+1), ascending, at zz (..., R)."""
    acc = torch.zeros_like(zz)
    for i in range(cfs.shape[-1] - 1, -1, -1):
        acc = acc * zz + cfs[..., i:i + 1]
    return acc


def nister_5point(x1n: torch.Tensor, x2n: torch.Tensor):
    """All essential matrices through 5 normalized correspondences.

    x1n, x2n: (..., 5, 2) in NORMALIZED camera coordinates.
    Returns (Es (..., 20, 3, 3) with ||E||_F = 1, valid (..., 20) bool):
    the <= 10 essential matrices appear among the 20 gated candidates (10
    from each root-finding chart; an overlap near |u| = 1 duplicates a
    model, which is harmless under a RANSAC vote). Invalid slots hold a
    dead model with huge Sampson residuals."""
    dt, dev = x1n.dtype, x1n.device
    lead = x1n.shape[:-2]
    Q = _epipolar_rows(x1n, x2n)  # (..., 5, 9)
    B = null_space_rows(Q)  # (..., 4, 9): X, Y, Z, W flattened

    # The 10 cubic constraints as trilinear forms over E's 9 entries: with
    # E = x X + y Y + z Z + W the monomial coefficients are
    # G_qijk = C_qabc B_ia B_jb B_kc.
    C = torch.from_numpy(_C_TENSOR).to(device=dev, dtype=dt)
    G = einsum_hp("qabc,...kc->...qabk", C, B)
    G = einsum_hp("...qabk,...jb->...qajk", G, B)
    G = einsum_hp("...qajk,...ia->...qijk", G, B)       # (..., 10, 4, 4, 4)
    A = matmul_hp(G.reshape(lead + (10, 64)),
                  torch.from_numpy(_MONO_MAP).to(device=dev, dtype=dt))  # (..., 10, 20)

    # Reduce [A1 | A2] -> [I | Ar]: one 10x10 solve; a singular A1 gives
    # inf or NaN, which the gate below turns into invalid candidates.
    Ar = torch.linalg.solve_ex(A[..., :10], A[..., 10:])[0]  # (..., 10, 10)
    a_ok = torch.isfinite(Ar).all(dim=-1).all(dim=-1)
    Ar = torch.where(a_ok[..., None, None], Ar, 0.0)
    # Row i: mono_i + x*(Ar[i,0] z^2 + Ar[i,1] z + Ar[i,2])
    #                + y*(Ar[i,3] z^2 + Ar[i,4] z + Ar[i,5])
    #                + (Ar[i,6] z^3 + Ar[i,7] z^2 + Ar[i,8] z + Ar[i,9]) = 0
    # Pair (x^2 z, x^2)=(4,5), (y^2 z, y^2)=(6,7), (xyz, xy)=(8,9): subtract
    # z*(second row) from the first to eliminate the leading monomial:
    #   x*alpha(z) + y*beta(z) + gamma(z) = 0.
    zero1 = torch.zeros(lead + (1,), dtype=dt, device=dev)

    def row_polys(i):
        # ascending coefficient vectors: p, q of degree 2; r of degree 3
        row = Ar[..., i, :]
        return row[..., [2, 1, 0]], row[..., [5, 4, 3]], row[..., [9, 8, 7, 6]]

    def raise_minus_shift(hi, lo):  # hi(z) - z * lo(z)
        return torch.cat([hi, zero1], dim=-1) - torch.cat([zero1, lo], dim=-1)

    L = []
    for hi, lo in ((4, 5), (8, 9), (6, 7)):
        ph, qh, rh = row_polys(hi)
        pl, ql, rl = row_polys(lo)
        L.append((raise_minus_shift(ph, pl), raise_minus_shift(qh, ql),
                  raise_minus_shift(rh, rl)))  # degrees 3, 3, 4
    (a1, b1, g1), (a2, b2, g2), (a3, b3, g3) = L
    # det of the 3x3 polynomial matrix: a degree-10 polynomial in z.
    poly = (
        _conv1(a1, _conv1(b2, g3) - _conv1(b3, g2))
        - _conv1(b1, _conv1(a2, g3) - _conv1(a3, g2))
        + _conv1(g1, _conv1(a2, b3) - _conv1(a3, b2))
    )  # (..., 11) ascending

    # Degree-10 root finding without `eig`. The roots can span three orders
    # of magnitude, beyond what one Durand-Kerner run from the unit circle
    # resolves in complex64. Four measures cover it: (1) shift z = v + delta
    # so that the constant term is generically nonzero; (2) substitute
    # v = s*u with s = (|q0|/|q10|)^(1/10), which puts the geometric mean of
    # the root magnitudes at |u| = 1; (3) run DK on both q(u) and its
    # reversal u^10 q(1/u): each resolves its own half of the disk; (4)
    # polish every candidate with Newton steps on its own side.
    q = matmul_hp(poly, torch.from_numpy(_SHIFT_MAT).to(device=dev, dtype=dt).T)
    lead_c, tail_c = q[..., 10], q[..., 0]
    floor = 1e-7 * q.abs().amax(dim=-1).clamp_min(1e-30)
    s = torch.where(
        (lead_c.abs() > floor) & (tail_c.abs() > floor),
        (tail_c.abs() / lead_c.abs().clamp_min(1e-30)) ** 0.1,
        1.0,
    )
    # q_u coefficients: q_i * s^i, then monic; the reversal flips the index.
    pu = q * s[..., None] ** torch.arange(11, dtype=dt, device=dev)
    pu = pu / torch.where(pu[..., 10:].abs() > 1e-30, pu[..., 10:], 1.0)
    pr_ = pu.flip(-1)
    pr_ = pr_ / torch.where(pr_[..., 10:].abs() > 1e-30, pr_[..., 10:], 1.0)

    charts = torch.stack([pu, pr_], dim=-2)       # (..., 2, 11)
    r = _dk_roots(charts)                         # (..., 2, 10)
    # gate: nearly real, a small residual of the real part, inside the
    # chart's own disk (|u| <~ 1 forward, |w| <~ 1 for the reversal)
    re = r.real
    resid = _horner_monic(charts, re.to(torch.complex64)).abs()
    near_real = r.imag.abs() <= 1e-3 * (1.0 + re.abs())
    ok = near_real & (resid < 1e-2 * (1.0 + re.abs()) ** 10) & (r.abs() <= 1.25)
    w_rev = r[..., 1, :]
    tiny = torch.full((), 1e-12, dtype=torch.complex64, device=dev)
    u_bwd = 1.0 / torch.where(w_rev.abs() > 1e-12, w_rev, tiny)
    roots = torch.cat([r[..., 0, :], u_bwd], dim=-1) * s[..., None] + _DELTA
    z = roots.real
    is_real = ok.reshape(lead + (20,)) & torch.isfinite(z)

    # Back-substitute x, y per root from two of the three equations, the
    # better-conditioned pair.
    A1, B1, G1 = _peval(a1, z), _peval(b1, z), _peval(g1, z)
    A2, B2, G2 = _peval(a2, z), _peval(b2, z), _peval(g2, z)
    A3, B3, G3 = _peval(a3, z), _peval(b3, z), _peval(g3, z)
    d12 = A1 * B2 - A2 * B1
    d13 = A1 * B3 - A3 * B1
    use13 = d13.abs() > d12.abs()
    dd = torch.where(use13, d13, d12)
    dd_safe = torch.where(dd.abs() > 1e-20, dd, 1.0)
    xs = torch.where(use13, B1 * G3 - B3 * G1, B1 * G2 - B2 * G1) / dd_safe
    ys = torch.where(use13, G1 * A3 - G3 * A1, G1 * A2 - G2 * A1) / dd_safe

    coef = torch.stack([xs, ys, z, torch.ones_like(z)], dim=-1)  # (..., 20, 4)
    Es = matmul_hp(coef, B)  # (..., 20, 9)
    nrm = torch.linalg.norm(Es, dim=-1)
    valid = (
        is_real & a_ok[..., None] & (dd.abs() > 1e-12)
        & (nrm > 1e-12) & torch.isfinite(Es).all(dim=-1)
    )
    Es = Es / nrm.clamp_min(1e-12)[..., None]
    dead = torch.from_numpy(_DEAD_E).to(device=dev, dtype=dt).reshape(9)
    Es = torch.where(valid[..., None], Es, dead)
    return Es.reshape(lead + (20, 3, 3)), valid
