"""Small batched linear-algebra helpers of the geometry code.

PyTorch port of recon3d_tpu/ops/linalg.py on its CPU branch: null vectors
come from torch.linalg.eigh of the normal matrix, rotations from
torch.linalg.svd. The Cholesky inverse iteration (`_smallest_eigvec_fast`,
behind the `fast` flag) and the polar branch of `nearest_rotation` exist in
the JAX package for the TPU only and are not ported, so `smallest_eigvec`
takes no `fast` flag: it is the exact eigh everywhere.

jnp.linalg returns NaN or inf where a matrix is singular or not finite, and
the geometry code relies on that (a bad hypothesis carries its NaN into a
finiteness gate and loses the vote). LAPACK under torch raises instead, so
the decompositions here see a finite stand-in for a non-finite matrix and
write NaN over its result (`_finite_in`/`_nan_out`), and the solves are the
unchecked `solve_ex`/`inv_ex`.

Every product here is a plain float32 product: TF32 is switched off for
the whole port (runtime/device.py), which is what Precision.HIGHEST asks
of the JAX code.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from recon3d_tpu_torch.ops.select import argmax_first, argmin_first

einsum_hp = torch.einsum

# torch.linalg.eigh on CUDA hands a batch of small matrices to cuSOLVER's
# batched solver in one call, and that call refuses batches of 32,768
# matrices and more (CUSOLVER_STATUS_INVALID_VALUE; 16,384 pass): larger
# batches go through in slices.
_EIGH_MAX_BATCH = 16384


def sum_batch_invariant(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x summed along `dim` in an order fixed by that axis's length alone:
    zero-padded to a power of 2 and halved by elementwise adds. A CUDA
    reduction splits a long axis by how many sums it computes, so a row of
    a batch would sum otherwise in a batch of another size (a mesh's shard
    of a chunk; scripts/batch_invariance_probe.py)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    size = 1 << max(n - 1, 0).bit_length()
    if size > n:
        x = torch.nn.functional.pad(x, (0, size - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def matmul_hp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-precision matmul for small geometry matrices."""
    return torch.matmul(a, b)


def _cholesky_unrolled(A: torch.Tensor) -> list:
    """Batched Cholesky of small (..., n, n) SPD matrices, unrolled into
    its n^3/6 scalar recurrences (elementwise work over the batch). Returns
    the lower factor as a list of lists of (...) tensors; a pivot that is
    not positive is clamped to 1e-30 instead of stopping the batch."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(s.clamp_min(1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def _chol_solve_unrolled(L: list, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b with the unrolled factor; b: (..., n)."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _finite_in(M: torch.Tensor):
    """(M with every non-finite matrix replaced by the identity, bad (...)):
    what a LAPACK or cuSOLVER decomposition may be given."""
    bad = ~torch.isfinite(M).all(dim=-1).all(dim=-1)
    eye = torch.eye(M.shape[-2], M.shape[-1], dtype=M.dtype, device=M.device)
    return torch.where(bad[..., None, None], eye, M), bad


def _nan_out(x: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
    """NaN over the results of the matrices `_finite_in` replaced."""
    bad = bad.reshape(bad.shape + (1,) * (x.dim() - bad.dim()))
    return torch.where(bad, float("nan"), x)


def eigh_batched(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch.linalg.eigh of symmetric (..., n, n) matrices in slices that
    cuSOLVER's batched solver takes; NaN for a non-finite matrix. Returns
    (w (..., n) ascending, V (..., n, n) with eigenvectors as columns)."""
    n = A.shape[-1]
    flat, bad = _finite_in(A.reshape(-1, n, n))
    parts = [torch.linalg.eigh(part) for part in flat.split(_EIGH_MAX_BATCH)]
    w = _nan_out(torch.cat([p[0] for p in parts]), bad)
    V = _nan_out(torch.cat([p[1] for p in parts]), bad)
    return w.reshape(A.shape[:-1]), V.reshape(A.shape)


def smallest_eigvec(A: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of a symmetric PSD (..., n, n)
    matrix: the null vector of the DLT and 8-point solvers (A^T A instead
    of an SVD of the tall matrix). Defined up to sign."""
    return eigh_batched(A)[1][..., :, 0]


def _unit(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(eps)


def null_space_rows(Q: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis (..., n - m, n), as rows, of the null space of
    full-rank (..., m, n) matrices with m < n: the last n - m columns of
    the orthogonal factor of a complete Householder QR of Q^T, with
    LAPACK's reflectors (beta = -sign(x_0) |x|), unrolled into elementwise
    work over the batch (a batched torch.linalg.qr on CUDA computes that
    factor matrix by matrix).

    The 5-point solver depends on which basis of the null space it is
    given, beyond its accuracy: it fixes the coefficient of the last basis
    vector to 1. With this basis it recovers as many essential matrices as
    the JAX function does with its QR; with the eigenvectors of the
    projector onto the null space (the same space, turned at random) it
    loses about a tenth of them."""
    m, n = Q.shape[-2:]
    A = Q.transpose(-1, -2).clone()                       # (..., n, m)
    reflectors = []
    for k in range(m):
        x = A[..., k:, k]
        norm = torch.linalg.norm(x, dim=-1)
        beta = torch.where(x[..., 0] < 0, norm, -norm)
        v = x.clone()
        v[..., 0] -= beta
        v = _unit(v)
        reflectors.append(v)
        sub = A[..., k:, k:]
        A[..., k:, k:] = sub - 2.0 * v[..., :, None] * (v[..., None, :] @ sub)
    cols = torch.eye(n, dtype=Q.dtype, device=Q.device)[:, m:].expand(Q.shape[:-2] + (n, n - m))
    cols = cols.clone()
    for k in reversed(range(m)):
        v = reflectors[k]
        sub = cols[..., k:, :]
        cols[..., k:, :] = sub - 2.0 * v[..., :, None] * (v[..., None, :] @ sub)
    return cols.transpose(-1, -2)


def eigh3x3(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Analytic symmetric 3x3 eigendecomposition (Cardano / Smith's method).

    Returns (w (..., 3) ascending, V (..., 3, 3) with eigenvectors as
    columns), in closed-form arithmetic only."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    Bm = A - q[..., None, None] * eye
    p2 = (Bm * Bm).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(p2.clamp_min(1e-30))
    detB = torch.linalg.det(Bm)
    # Exactly isotropic input: p**3 underflows and detB / (2 p^3) is 0/0;
    # every r is a correct limit there, so r = 1 (phi = 0).
    iso = p2 < 1e-24
    r = torch.where(
        iso, torch.ones_like(detB),
        (detB / (2.0 * p**3).clamp_min(1e-30)).clamp(-1.0, 1.0),
    )
    phi = torch.acos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)                       # largest
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    e2 = 3.0 * q - e1 - e3
    w = torch.stack([e3, e2, e1], dim=-1)

    def eigvec(lam, fallback_axis):
        # v spans null(A - lam I): cross products of row pairs, the pair
        # with the largest cross norm.
        M = A - lam[..., None, None] * eye
        c01 = torch.linalg.cross(M[..., 0, :], M[..., 1, :])
        c12 = torch.linalg.cross(M[..., 1, :], M[..., 2, :])
        c20 = torch.linalg.cross(M[..., 2, :], M[..., 0, :])
        cands = torch.stack([c01, c12, c20], dim=-2)
        norms = torch.linalg.norm(cands, dim=-1)
        best = argmax_first(norms, -1)
        v = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
        # Near-isotropic: each call falls back to its own canonical axis,
        # so the two calls cannot collapse onto the same one.
        ok = norms.amax(dim=-1) > 1e-20
        fb = torch.zeros_like(v)
        fb[..., fallback_axis] = 1.0
        v = torch.where(ok[..., None], v, fb)
        return _unit(v)

    v3 = eigvec(e3, 0)
    v1 = eigvec(e1, 2)
    v1 = v1 - (v1 * v3).sum(-1, keepdim=True) * v3
    # Near-isotropic A: Gram-Schmidt may collapse v1; complete the basis
    # from the coordinate axis least aligned with v3.
    n1 = torch.linalg.norm(v1, dim=-1, keepdim=True)
    axis = torch.nn.functional.one_hot(argmin_first(v3.abs(), -1), 3).to(v3.dtype)
    alt = axis - (axis * v3).sum(-1, keepdim=True) * v3
    v1 = _unit(torch.where(n1 > 1e-4, v1, alt))
    v2 = torch.linalg.cross(v3, v1)
    return w, torch.stack([v3, v2, v1], dim=-1)


def nearest_rotation(M: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto SO(3) (det +1) through the SVD:
    U diag(1, 1, det(U V^T)) V^T; NaN for a non-finite M."""
    M, bad = _finite_in(M)
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return _nan_out((U * D[..., None, :]) @ Vt, bad)


def solve_psd(A: torch.Tensor, b: torch.Tensor, damping: float = 0.0) -> torch.Tensor:
    """Solve (A + damping*I) x = b for symmetric PSD A via Cholesky; b is
    (..., n) or (..., n, m)."""
    n = A.shape[-1]
    if damping:
        A = A + damping * torch.eye(n, dtype=A.dtype, device=A.device)
    vec = b.dim() == A.dim() - 1
    L = torch.linalg.cholesky(A)
    x = torch.cholesky_solve(b[..., None] if vec else b, L)
    return x[..., 0] if vec else x


def homogeneous(x: torch.Tensor) -> torch.Tensor:
    """Append a 1 to the last axis: (..., n) -> (..., n+1)."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def from_homogeneous(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Dehomogenize: (..., n+1) -> (..., n), sign-safe near w=0."""
    w = x[..., -1:]
    w = torch.where(w.abs() < eps, torch.where(w < 0, -eps, eps).to(w.dtype), w)
    return x[..., :-1] / w

