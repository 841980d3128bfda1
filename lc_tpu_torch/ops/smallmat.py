"""Small dense linear algebra for the PnP estimators (counterpart of
lc_tpu/ops/smallmat.py).

lc_tpu writes every tiny contraction as broadcast-multiply-reduce because the
TPU's matrix unit wastes its 128x128 tiles on them; on the card plain f32
matmuls are right, so the port keeps only the results:
  * SPD solves go through torch.linalg.cholesky_ex / cholesky_solve (the same
    factorization as lc_tpu's unrolled Cholesky, rounding-level differences);
  * the fixed-sweep cyclic Jacobi eigensolver (3x3 PCA frames, and the 4x4
    Rayleigh-Ritz step of EPnP's 12x12 near-null space) and the shifted
    inverse subspace iteration are kept as algorithms, because their
    truncation is part of lc_tpu's answer: the eigenvector signs of the
    Jacobi sweeps fix EPnP's control points, and three subspace iterations
    are not an exact eigendecomposition. Each Jacobi rotation is one plane
    rotation applied as two batched products, six device operations, with
    no workspace beyond its operands (torch.linalg.eigh's batched workspace
    was RANSAC's device-memory peak).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def rot_pts(pts: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """pts (..., N, 3) @ Rᵀ (..., 3, 3) -> (..., N, 3), with broadcasting."""
    return pts @ R.transpose(-1, -2)


def chol_solve(A: torch.Tensor, b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve SPD A (..., n, n) x = b (..., n) or (..., n, m). Returns (x, ok);
    where the factorization failed (not SPD) ok is False and x stays finite."""
    L, info = torch.linalg.cholesky_ex(A)
    ok = info == 0
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    L = torch.where(ok[..., None, None], L, eye)
    vec = b.dim() == A.dim() - 1
    x = torch.cholesky_solve(b[..., None] if vec else b, L)
    return (x[..., 0] if vec else x), ok


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (..., 3, 3) with a guarded determinant."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det,
                                torch.sign(det) * 1e-30 + (det == 0) * 1e-30)
    rows = torch.stack([torch.stack([A, B, C], -1),
                        torch.stack([D, E, F], -1),
                        torch.stack([G, H, I], -1)], -2)
    return rows * inv_det[..., None, None]


@functools.lru_cache(maxsize=16)
def _plane_rotations(n: int, dtype, device) -> tuple:
    """For every (p, q) of the cyclic order: W (n², 2), which maps A's
    entries to z = (A_pp - A_qq) + 2i A_pq (its half argument is the
    rotation angle), the bias b (2,) that makes z = 0 turn by angle 0, and
    C0 (5n²), Ccs (2, 5n²), which give the plane rotation J (n, n) and the
    block matrix blockdiag(Jᵀ, I) (2n, 2n), flattened one after the other,
    as C0 + (cos, sin) @ Ccs."""
    out = []
    b = torch.tensor([torch.finfo(dtype).tiny, 0.0], dtype=dtype)
    for p in range(n - 1):
        for q in range(p + 1, n):
            W = torch.zeros(n * n, 2, dtype=dtype)
            W[p * n + p, 0], W[q * n + q, 0], W[p * n + q, 1] = 1.0, -1.0, 2.0
            J0 = torch.eye(n, dtype=dtype)
            J0[p, p] = J0[q, q] = 0.0
            Jc = torch.zeros(n, n, dtype=dtype)
            Jc[p, p] = Jc[q, q] = 1.0
            Js = torch.zeros(n, n, dtype=dtype)
            Js[q, p], Js[p, q] = 1.0, -1.0
            eye = torch.eye(n, dtype=dtype)
            parts = [torch.cat((J.flatten(), torch.block_diag(
                J.T, eye if J is J0 else 0 * eye).flatten()))
                for J in (J0, Jc, Js)]
            out.append(tuple(t.to(device) for t in (
                W, b, parts[0], torch.stack(parts[1:]))))
    return tuple(out)


def jacobi_eigh_small(A: torch.Tensor, sweeps: int = 8
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition of tiny matrices by cyclic Jacobi with a
    fixed number of sweeps (lc_tpu's rotation order and angles). A
    (..., n, n) -> (eigvals (..., n) ascending, eigvecs (..., n, n)
    columns). A non-finite A gives non-finite results.

    A and the eigenvectors V travel stacked as M = [A; V] (2n, n); a
    rotation is M <- blockdiag(Jᵀ, I) M J, its cosine and sine the square
    root of z/|z| (z of _plane_rotations): six device operations."""
    n = A.shape[-1]
    batch = A.shape[:-2]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    M = torch.cat((A, eye.expand(A.shape)), -2).reshape(-1, 2 * n, n)
    P = M.shape[0]
    for _ in range(sweeps):
        for W, b, C0, Ccs in _plane_rotations(n, A.dtype,
                                              torch.device(A.device)):
            z = torch.addmm(b, M[:, :n].reshape(P, n * n), W)
            cs = torch.view_as_real(torch.sqrt(torch.sgn(
                torch.view_as_complex(z))))
            JL = torch.addmm(C0, cs, Ccs)
            M = torch.bmm(torch.bmm(JL[:, n * n:].view(P, 2 * n, 2 * n), M),
                          JL[:, :n * n].view(P, n, n))
    M = M.reshape(batch + (2 * n, n))
    vals = torch.diagonal(M[..., :n, :], dim1=-2, dim2=-1)
    order = torch.argsort(vals, dim=-1, stable=True)
    vals = torch.gather(vals, -1, order)
    V = torch.gather(M[..., n:, :], -1, order[..., None, :].expand(A.shape))
    return vals, V


def _orthonormalize_cols(X: torch.Tensor) -> torch.Tensor:
    """Modified Gram-Schmidt over the (small) last axis."""
    out = []
    for i in range(X.shape[-1]):
        v = X[..., i]
        for u in out:
            v = v - torch.sum(u * v, -1, keepdim=True) * u
        norm = torch.sqrt(torch.clamp(torch.sum(v * v, -1, keepdim=True),
                                      min=1e-30))
        out.append(v / norm)
    return torch.stack(out, dim=-1)


def start_basis(n: int, k: int) -> np.ndarray:
    """lc_tpu's deterministic start basis of the shifted inverse subspace
    iteration: the Q factor of a (n, k) Gaussian from default_rng(7), float64
    (lc_tpu/ops/smallmat.py, lc_tpu/pnp/fast_minimal.py)."""
    return np.linalg.qr(np.random.default_rng(7).normal(size=(n, k)))[0]


def smallest_eigvecs(A: torch.Tensor, k: int, iters: int = 6
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest eigenpairs of symmetric PSD A (..., n, n) by shifted
    inverse subspace iteration from lc_tpu's fixed start basis, then a
    Rayleigh-Ritz step. Returns (eigvecs (..., n, k) ascending, eigvals)."""
    n = A.shape[-1]
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    shift = (1e-6 * tr / n + 1e-25)[..., None, None]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    L, info = torch.linalg.cholesky_ex(A + shift * eye)
    L = torch.where((info == 0)[..., None, None], L, eye)
    X = torch.as_tensor(start_basis(n, k), dtype=A.dtype,
                        device=A.device).expand(A.shape[:-2] + (n, k))
    for _ in range(iters):
        X = _orthonormalize_cols(torch.cholesky_solve(X, L))
    T = X.transpose(-1, -2) @ A @ X
    T = 0.5 * (T + T.transpose(-1, -2))
    # a degenerate sample carries a non-finite X, hence T; the Jacobi sweeps
    # keep it non-finite, so the caller rejects it
    vals, Q = jacobi_eigh_small(T)
    return X @ Q, vals
