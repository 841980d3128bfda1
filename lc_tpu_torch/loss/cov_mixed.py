"""The Linear-Covariance pose loss (counterpart of lc_tpu/loss/cov_mixed.py,
reference lib/cov_mixed.py:100-150):

    loss = log(prior_err) + 0.5 · (cov_err + linear_err) / prior_err

prior_err is the bbox-propagated size of the prior pose covariance
(JᵀWJ)⁻¹, cov_err propagates the estimated 2D error covariance through the
pose-update jacobian, and linear_err is the linearized pose error of the
(clamped, detached) residuals. All three are differentiable functions of the
per-pixel weights. Every stop_gradient of lc_tpu is a .detach() at the same
place.
"""
from __future__ import annotations

import torch

from ..geom.pose import pose7_to_RT
from ..geom.projection import project_apply
from ..geom.rotations import skew_symmetric
from ..pnp.covariance import weighted_pnp_jac_cov
from ..pnp.residual import residual_with_jac6d


def twice_huber(val_abs: torch.Tensor, delta) -> torch.Tensor:
    """x² below delta, linear (slope 2·delta) above."""
    if isinstance(delta, torch.Tensor):
        delta = delta.detach()
    return torch.where(val_abs > delta, delta * (2.0 * val_abs - delta),
                       val_abs ** 2)


def clamp_error(error: torch.Tensor, max_err_len) -> torch.Tensor:
    """Shrink 2D error vectors longer than max_err_len to that length; the
    shrink is detached, so gradients see a pure translation."""
    if isinstance(max_err_len, torch.Tensor):
        max_err_len = max_err_len[..., None]
    err_len = torch.linalg.norm(error, dim=-1) + 1e-6
    f = ((err_len - max_err_len) / err_len)[..., None]
    delta = torch.where(f > 0, f * error, 0.0).detach()
    return error - delta


def robust_weights_cov(inv_std2d_pred: torch.Tensor, error2d: torch.Tensor,
                       valid_mask: torch.Tensor | None,
                       rel_thresh: float = 3.0, w_e_thresh: float = 4.0):
    """Robust (twice-Huber) weights and the per-point error covariance
    estimate, both (..., N, 2)."""
    error = torch.abs(error2d)
    if valid_mask is not None:
        vm = valid_mask[..., None]
        vcnt = valid_mask.sum(-1, keepdim=True)[..., None]
        mean_abs = (error * vm).sum(-2, keepdim=True) / vcnt
    else:
        mean_abs = error.mean(-2, keepdim=True)
    cov = twice_huber(error, mean_abs.detach() * rel_thresh)
    w_e = ((inv_std2d_pred ** 2) * cov).detach()
    if valid_mask is not None:
        mean_w_e = (w_e * vm).sum(-2, keepdim=True) / vcnt
    else:
        mean_w_e = w_e.mean(-2, keepdim=True)
    delta_inv_std = torch.sqrt((mean_w_e * w_e_thresh) / (cov.detach() + 1e-6))
    return twice_huber(inv_std2d_pred, delta_inv_std), cov


def xform_3d(state: torch.Tensor, bbox3d: torch.Tensor) -> torch.Tensor:
    """Pose -> the flattened world coordinates of the 8 bbox corners (..., 24)."""
    R, t = pose7_to_RT(state)
    pts = bbox3d @ R.transpose(-1, -2) + t[..., None, :]
    return pts.reshape(pts.shape[:-2] + (-1,))


def xform_2d(state: torch.Tensor, cam_K: torch.Tensor,
             bbox3d: torch.Tensor) -> torch.Tensor:
    """Pose -> the flattened 2D projections of the 8 bbox corners (..., 16)."""
    R, t = pose7_to_RT(state)
    uv = project_apply(cam_K, bbox3d, R, t)
    return uv.reshape(uv.shape[:-2] + (-1,))


def transformed_cov_from_jac(update_cov: torch.Tensor,
                             jac: torch.Tensor) -> torch.Tensor:
    """diag(J C Jᵀ) per output dim: (..., D) from C (..., 6, 6), J (..., D, 6)."""
    return ((jac @ update_cov) * jac).sum(-1)


def _loss_cov_nd(cov_diag: torch.Tensor, nd: int) -> torch.Tensor:
    """Mean per-corner std from a per-dim covariance diagonal (B, 8·nd); a
    non-positive entry (numerical failure) collapses the sample to 1."""
    B = cov_diag.shape[0]
    good = (cov_diag > 0).all(-1, keepdim=True)
    per_pt = torch.where(good, cov_diag.reshape(B, -1, nd).sum(-1), 1.0)
    return torch.sqrt(per_pt).mean(-1)


def jac_update_to_alter(pose: torch.Tensor, bbox_3d: torch.Tensor,
                        cam_K: torch.Tensor | None = None) -> torch.Tensor:
    """Jacobian of the corners' xform at apply_perturb(pose, δ), δ = 0:
    (B, 24, 6) in 3D, (B, 16, 6) in 2D when cam_K is given. lc_tpu takes it
    with a vmapped jacfwd; here it is the closed form of the same chart,
    R' = R·R(δ_rot), t' = t + δ_t: a corner X moves by [R·skew(X)ᵀ | I], and
    in 2D that goes through the projection's jacobian, which is
    pnp.residual's. Detached: the jacobian is a constant of the loss."""
    pose, bbox_3d = pose.detach(), bbox_3d.detach()
    B = pose.shape[0]
    if cam_K is not None:
        _, J = residual_with_jac6d(pose, cam_K.detach(), bbox_3d,
                                   torch.zeros_like(bbox_3d[..., :2]))
        return J.reshape(B, -1, 6)
    R, _ = pose7_to_RT(pose)
    d_rot = R[:, None] @ skew_symmetric(bbox_3d).transpose(-1, -2)   # (B,8,3,3)
    eye = torch.eye(3, dtype=pose.dtype, device=pose.device).expand_as(d_rot)
    return torch.cat((d_rot, eye), -1).reshape(B, -1, 6)


def loss_cov_mixed(K_out: torch.Tensor, pose_gt: torch.Tensor,
                   pts3d: torch.Tensor, pts2d_out: torch.Tensor,
                   inv_std2d: torch.Tensor, valid_factor: torch.Tensor | None,
                   *, bbox_3d: torch.Tensor, max_err_len: float = 32.0,
                   rel_thresh: float = 3.0, w_e_thresh: float = 4.0,
                   cov_2d: bool = False) -> torch.Tensor:
    """Per-sample LC loss (B,).

    K_out (B, 3, 3) the crop's camera; pose_gt (B, 7); pts3d (B, N, 3) the
    predicted 3D correspondences; pts2d_out (B, N, 2) their pixels;
    inv_std2d (B, N, 2) the predicted inverse stds; valid_factor (B, N) or
    None; bbox_3d (B, 8, 3) the model's bbox corners."""
    R, t = pose7_to_RT(pose_gt)
    pts2d_proj = project_apply(K_out, pts3d, R, t)
    error_clamped = clamp_error(pts2d_out - pts2d_proj, max_err_len)
    weights, cov_est = robust_weights_cov(inv_std2d, error_clamped,
                                          valid_factor, rel_thresh=rel_thresh,
                                          w_e_thresh=w_e_thresh)
    pjc = weighted_pnp_jac_cov(pose_gt.detach(), K_out.detach(),
                               pts3d.detach(), pts2d_proj.detach(), weights,
                               valid=valid_factor)
    B, N = pts2d_out.shape[:2]
    jac_d = pjc.jac.reshape(B, 6, 2 * N)
    jac_a = jac_update_to_alter(pose_gt, bbox_3d, K_out if cov_2d else None)
    err_dim = 2 if cov_2d else 3

    prior_err = _loss_cov_nd(transformed_cov_from_jac(pjc.cov, jac_a), err_dim)

    cov_flat = cov_est.reshape(B, 2 * N)
    half = (jac_d * cov_flat[:, None, :]) @ jac_d.transpose(-1, -2) * 0.5
    update_cov = half + half.transpose(-1, -2)
    cov_err = _loss_cov_nd(transformed_cov_from_jac(update_cov, jac_a), err_dim)

    err_flat = error_clamped.detach().reshape(B, 2 * N, 1)
    delta = (jac_a @ (jac_d @ err_flat))[..., 0]
    linear_err = torch.linalg.norm(delta.reshape(B, 8, err_dim), dim=-1).mean(-1)
    return torch.log(prior_err) + 0.5 * (cov_err + linear_err) / prior_err
