"""Differentiable weighted-PnP covariance in closed form (counterpart of
lc_tpu/pnp/covariance.py).

At the GT operating point with pts2d the GT projections, the residual is
zero, so with the per-point jacobians J of the residual wrt a pose update:

    H              = Σ_{n,c} w_{nc} J_{nc} J_{nc}ᵀ   (the r·∂²r term vanishes)
    cov            = H⁻¹                              (prior pose covariance)
    ∂update/∂pts2d = H⁻¹ (w ⊙ J)

Two batched products and one Cholesky, differentiable in the weights
through torch's cholesky/cholesky_solve rules.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .residual import residual_with_jac6d


def safe_cholesky(spd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cholesky with an identity fallback: returns (L, invalid).

    A non-SPD matrix (found on a detached copy, so the test never enters the
    gradient) is replaced by I and flagged."""
    L0, info = torch.linalg.cholesky_ex(spd.detach())
    invalid = (info != 0) | ~torch.isfinite(L0).all(-1).all(-1)
    eye = torch.eye(spd.shape[-1], dtype=spd.dtype, device=spd.device)
    fixed = torch.where(invalid[..., None, None], eye, spd)
    return torch.linalg.cholesky(fixed), invalid


class PnPJacCov(NamedTuple):
    invalid: torch.Tensor    # (...,) bool: non-SPD normal equations
    jac: torch.Tensor        # (..., 6, N, 2) ∂update/∂pts2d
    cov: torch.Tensor        # (..., 6, 6) prior pose covariance H⁻¹
    hess_L: torch.Tensor     # (..., 6, 6) Cholesky factor of H


def weighted_pnp_jac_cov(pose_gt: torch.Tensor, cam_K: torch.Tensor,
                         pts3d: torch.Tensor, pts2d: torch.Tensor,
                         weights: torch.Tensor,
                         valid: torch.Tensor | None = None) -> PnPJacCov:
    """The jacobian of the Gauss-Newton pose update wrt the 2D points, and
    the prior covariance.

    pose_gt (..., 7); cam_K (..., 3, 3); pts3d (..., N, 3); pts2d (..., N, 2)
    the GT projections; weights (..., N, 2) per-coordinate inverse variances
    (the gradient path); valid (..., N) an optional mask of padded points."""
    _, J = residual_with_jac6d(pose_gt, cam_K, pts3d, pts2d)   # (..., N, 2, 6)
    w = weights
    if valid is not None:
        w = w * valid[..., None].to(w.dtype)
    wJ = w[..., None] * J
    H = torch.einsum('...nci,...ncj->...ij', wJ, J)
    H = 0.5 * (H + H.transpose(-1, -2))
    L, invalid = safe_cholesky(H)
    batch, N = wJ.shape[:-3], wJ.shape[-3]
    rhs = wJ.reshape(batch + (N * 2, 6)).transpose(-1, -2)      # (..., 6, 2N)
    jac = torch.cholesky_solve(rhs, L).reshape(batch + (6, N, 2))
    eye = torch.eye(6, dtype=H.dtype, device=H.device).expand(H.shape)
    cov = torch.cholesky_solve(eye, L)
    return PnPJacCov(invalid=invalid, jac=jac, cov=cov, hess_L=L)


class _PnPUpdate(torch.autograd.Function):
    """Forward zeros (the operating point is the optimum); backward routes
    the cotangent through −H⁻¹ (the implicit function theorem)."""

    @staticmethod
    def forward(ctx, hess_L, jtr):
        ctx.save_for_backward(hess_L)
        return torch.zeros(hess_L.shape[:-2] + (6,), dtype=hess_L.dtype,
                           device=hess_L.device)

    @staticmethod
    def backward(ctx, g):
        (hess_L,) = ctx.saved_tensors
        return (torch.zeros_like(hess_L),
                -torch.cholesky_solve(g[..., None], hess_L)[..., 0])


def pnp_update(hess_L: torch.Tensor, jtr: torch.Tensor) -> torch.Tensor:
    """The implicit Gauss-Newton update (zeros forward, −H⁻¹ backward); the
    LC loss itself uses the closed form of weighted_pnp_jac_cov."""
    return _PnPUpdate.apply(hess_L, jtr)
