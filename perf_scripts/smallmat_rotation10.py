"""A ten-operation form of jacobi_eigh_small (atan2, cos, sin, the plane
rotation built by addcmul, Jᵀ A J and V J as three products), used for the
4x4 Rayleigh-Ritz step and the 3x3 frames. Kept for
ransac_eigensolve_ab.py's comparison with lc_tpu_torch/ops/smallmat.py's
six-operation form."""
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
def _plane_masks(n, dtype, device):
    out = []
    for p in range(n - 1):
        for q in range(p + 1, n):
            W = torch.zeros(n * n, 2, dtype=dtype)
            W[p * n + q, 0] = 2.0
            W[p * n + p, 1] = 1.0
            W[q * n + q, 1] = -1.0
            J0 = torch.eye(n, dtype=dtype)
            J0[p, p] = J0[q, q] = 0.0
            Jc = torch.zeros(n, n, dtype=dtype)
            Jc[p, p] = Jc[q, q] = 1.0
            Js = torch.zeros(n, n, dtype=dtype)
            Js[q, p], Js[p, q] = 1.0, -1.0
            out.append(tuple(t.to(device) for t in (W, J0, Jc, Js)))
    return tuple(out)


def jacobi_eigh_small(A, sweeps=8):
    n = A.shape[-1]
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    for _ in range(sweeps):
        for W, J0, Jc, Js in _plane_masks(n, A.dtype, torch.device(A.device)):
            yx = A.flatten(-2) @ W
            theta = (0.5 * torch.atan2(yx[..., 0], yx[..., 1]))[..., None, None]
            J = torch.addcmul(torch.addcmul(J0, torch.cos(theta), Jc),
                              torch.sin(theta), Js)
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    vals = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(vals, dim=-1, stable=True)
    vals = torch.gather(vals, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
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
    X0 = np.linalg.qr(np.random.default_rng(7).normal(size=(n, k)))[0]
    X = torch.as_tensor(X0, dtype=A.dtype, device=A.device).expand(
        A.shape[:-2] + (n, k))
    for _ in range(iters):
        X = _orthonormalize_cols(torch.cholesky_solve(X, L))
    T = X.transpose(-1, -2) @ A @ X
    T = 0.5 * (T + T.transpose(-1, -2))
    # eigh raises on non-finite input (degenerate samples); such rows carry a
    # non-finite X, so their result stays non-finite and the caller rejects it
    vals, Q = jacobi_eigh_small(T)
    return X @ Q, vals
