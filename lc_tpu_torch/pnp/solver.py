"""Batched trust-region Levenberg-Marquardt PnP refiner — the Ceres replacement
(counterpart of lc_tpu/pnp/solver.py).

`lm_refine` is the plain PyTorch version: the whole batch advances in lockstep
and converged problems are masked out, so each problem follows the same
trajectory it would alone. `lm_refine_auto` sends CUDA tensors to the
hand-written kernel (pnp/lm_kernel.py), which stops each problem on its own,
and CPU tensors to `lm_refine`.

Ceres's LM strategy, kept rule for rule:
  * step: (H + 1/radius · DᵀD) δ = −g with D = √diag(H) clamped to
    [min_lm_diagonal, max_lm_diagonal] (Ceres defaults 1e-6 / 1e32);
  * step quality ρ = (cost − new_cost) / (model cost decrease); accept when
    ρ > min_relative_decrease (1e-3);
  * on accept: radius /= max(1/3, 1 − (2ρ−1)³), decrease factor resets to 2;
    on reject: radius /= decrease_factor, decrease factor doubles;
  * convergence: |Δcost| ≤ function_tolerance · cost on an accepted step,
    trust-region collapse (radius ≤ 1e-32) or a vanishing model decrease;
  * problems with < 3 valid points are skipped and flagged invalid;
  * invalid solves keep the initial state unless fallback_to_init=False.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom.pose import apply_perturb
from .residual import residual_with_jac6d


class LMResult(NamedTuple):
    pose7: torch.Tensor      # (B, 7) refined (or initial if invalid)
    invalid: torch.Tensor    # (B,) bool
    cost: torch.Tensor       # (B,) final 0.5·Σ w r²
    n_iter: torch.Tensor     # (B,) int32 iterations consumed
    radius: torch.Tensor     # (B,) final trust-region radius


def prepare_weights(pts2d: torch.Tensor, weights: torch.Tensor,
                    valid: torch.Tensor | None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-coordinate weights (B, N, 2) in pts2d's precision (at least f32)
    with masked points zeroed, and the count of valid points per problem (B,)
    int32."""
    dt = torch.promote_types(pts2d.dtype, torch.float32)
    if weights.dim() == pts2d.dim() - 1:
        weights = weights[..., None]
    w2 = weights.to(dt).expand(pts2d.shape)
    if valid is not None:
        w2 = w2 * valid[..., None].to(dt)
        n_valid = valid.to(torch.int32).sum(-1, dtype=torch.int32)
    else:
        n_valid = torch.full(pts2d.shape[:-2], pts2d.shape[-2],
                             dtype=torch.int32, device=pts2d.device)
    return w2.contiguous(), n_valid


def _gauss_newton_terms(pose, cam_K, pts3d, pts2d, w2):
    r, J = residual_with_jac6d(pose, cam_K, pts3d, pts2d)
    g = torch.einsum('bnci,bnc->bi', J, w2 * r)
    H = torch.einsum('bnci,bnc,bncj->bij', J, w2, J)
    cost = 0.5 * torch.sum(w2 * r * r, dim=(-1, -2))
    return cost, g, H


def _weighted_cost(pose, cam_K, pts3d, pts2d, w2):
    r, _ = residual_with_jac6d(pose, cam_K, pts3d, pts2d)
    return 0.5 * torch.sum(w2 * r * r, dim=(-1, -2))


def lm_refine(pose7_init: torch.Tensor, cam_K: torch.Tensor,
              pts3d: torch.Tensor, pts2d: torch.Tensor, weights: torch.Tensor,
              valid: torch.Tensor | None = None, *,
              max_iter: int = 50, function_tolerance: float = 1e-6,
              initial_radius: float = 1e4, min_relative_decrease: float = 1e-3,
              min_lm_diagonal: float = 1e-6, max_lm_diagonal: float = 1e32,
              fallback_to_init: bool = True) -> LMResult:
    """Refine a batch of weighted PnP problems (plain PyTorch version).

    pose7_init: (B, 7); cam_K: (B, 3, 3); pts3d: (B, N, 3); pts2d: (B, N, 2);
    weights: per-coordinate inverse variances, (B, N, 2) or (B, N); valid:
    (B, N) bool mask. f32 as the kernel takes them; given f64 inputs it
    runs in f64, the referee chip_smoke.py holds the kernel's disagreements
    with this f32 version to.

    fallback_to_init=True is the Ceres contract: NO_CONVERGENCE returns the
    initial pose flagged invalid. fallback_to_init=False returns the last
    accepted iterate instead, for a budgeted polish that scores the result
    itself; the invalid flag keeps its Ceres meaning either way.
    """
    w2, n_valid = prepare_weights(pts2d, weights, valid)
    dt = w2.dtype
    pose7_init = pose7_init.to(dt)
    too_few = n_valid < 3
    B = pose7_init.shape[0]
    dev = pose7_init.device
    eye6 = torch.eye(6, dtype=dt, device=dev)

    pose = pose7_init
    cost = _weighted_cost(pose, cam_K, pts3d, pts2d, w2)
    radius = torch.full((B,), initial_radius, dtype=dt, device=dev)
    decrease_factor = torch.full((B,), 2.0, dtype=dt, device=dev)
    done = too_few.clone()
    n_iter = torch.zeros((B,), dtype=torch.int32, device=dev)

    for _ in range(max_iter):
        if bool(done.all()):
            break
        cost_now, g, H = _gauss_newton_terms(pose, cam_K, pts3d, pts2d, w2)
        diag = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1),
                           min_lm_diagonal, max_lm_diagonal)
        mu = 1.0 / radius
        H_lm = H + mu[:, None, None] * (eye6 * diag[:, None, :])
        L, info = torch.linalg.cholesky_ex(H_lm)
        chol_ok = info == 0
        # a failed factor holds garbage; its step is rejected below, so give
        # it the identity factor to keep every value finite
        L = torch.where(chol_ok[:, None, None], L, eye6)
        delta = -torch.cholesky_solve(g[..., None], L)[..., 0]

        new_pose = apply_perturb(pose, delta)
        new_cost = _weighted_cost(new_pose, cam_K, pts3d, pts2d, w2)

        Hd = torch.einsum('bij,bj->bi', H, delta)
        model_decrease = -(torch.sum(g * delta, -1)
                           + 0.5 * torch.sum(delta * Hd, -1))
        rho = (cost_now - new_cost) / torch.clamp(model_decrease, min=1e-30)
        accept = chol_ok & (model_decrease > 0) & (rho > min_relative_decrease) \
            & torch.isfinite(new_cost)

        shrink = 2.0 * rho - 1.0
        grow = torch.clamp(1.0 - shrink ** 3, min=1.0 / 3.0)
        new_radius = torch.where(accept, radius / grow, radius / decrease_factor)
        new_radius = torch.clamp(new_radius, 1e-32, 1e16)
        new_df = torch.where(accept, torch.full_like(decrease_factor, 2.0),
                             decrease_factor * 2.0)

        converged = accept & (torch.abs(cost_now - new_cost)
                              <= function_tolerance * cost_now)
        collapsed = new_radius <= 1e-32
        stalled = chol_ok & (model_decrease <= function_tolerance
                             * torch.clamp(cost_now, min=1e-30))

        active = ~done
        take = active & accept
        pose = torch.where(take[:, None], new_pose, pose)
        cost = torch.where(take, new_cost, cost)
        radius = torch.where(active, new_radius, radius)
        decrease_factor = torch.where(active, new_df, decrease_factor)
        done = torch.where(active, converged | collapsed | stalled | done, done)
        n_iter = n_iter + active.to(torch.int32)

    invalid = ~done | too_few
    keep_init = invalid if fallback_to_init else too_few
    pose = torch.where(keep_init[:, None], pose7_init, pose)
    return LMResult(pose7=pose, invalid=invalid, cost=cost, n_iter=n_iter,
                    radius=radius)


def lm_refine_auto(pose7_init, cam_K, pts3d, pts2d, weights, valid=None, *,
                   max_iter: int = 50, function_tolerance: float = 1e-6,
                   fallback_to_init: bool = True) -> LMResult:
    """LM refine dispatched on the tensors' device: a CUDA tensor goes to the
    fused kernel (pnp/lm_kernel.py), a CPU tensor to `lm_refine`. Both
    branches take only what the kernel takes, checked once here
    (lm_kernel.check_inputs)."""
    from . import lm_kernel
    lm_kernel.check_inputs(pose7_init, cam_K, pts3d, pts2d, weights, valid)
    if pose7_init.is_cuda:
        return lm_kernel.launch(pose7_init, cam_K, pts3d, pts2d, weights,
                                valid, max_iter, function_tolerance,
                                fallback_to_init)
    return lm_refine(pose7_init, cam_K, pts3d, pts2d, weights, valid,
                     max_iter=max_iter, function_tolerance=function_tolerance,
                     fallback_to_init=fallback_to_init)
