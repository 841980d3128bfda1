"""Analytic reprojection residual and jacobian wrt a right pose perturbation
(counterpart of lc_tpu/pnp/residual.py).

Convention: R' = R · R(δ_rot), t' = t + δ_t, jacobian at δ = 0 with columns
[δ_rot(3), δ_t(3)].
"""
from __future__ import annotations

import torch

from ..geom.rotations import quaternion_to_matrix, skew_symmetric


def residual_with_jac6d(pose7: torch.Tensor, cam_K: torch.Tensor,
                        pts3d: torch.Tensor, pts2d: torch.Tensor,
                        min_z: float = 1e-6
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual r = proj(pose, X) − x and jacobian ∂r/∂δ at δ = 0.

    pose7: (..., 7); cam_K: (..., 3, 3); pts3d: (..., N, 3); pts2d: (..., N, 2).
    Returns r (..., N, 2), J (..., N, 2, 6).

    p = R(R(δ)X) + t + δt, so ∂p/∂δ_rot = R·skew(X)ᵀ and ∂p/∂δ_t = I;
    u0 = p_xy/p_z has ∂u0/∂p = (1/z)[I₂ | −u0]; uv = K₂ₓ₂·u0 + c.
    """
    R = quaternion_to_matrix(pose7[..., :4])
    t = pose7[..., 4:7]
    p = torch.einsum('...ij,...nj->...ni', R, pts3d) + t[..., None, :]

    inv_z = 1.0 / torch.clamp(p[..., 2], min=min_z)
    u0 = p[..., :2] * inv_z[..., None]

    K22 = cam_K[..., :2, :2]
    uv = torch.einsum('...ij,...nj->...ni', K22, u0) + cam_K[..., None, :2, 2]
    r = uv - pts2d

    eye2 = torch.eye(2, dtype=u0.dtype, device=u0.device).expand(
        u0.shape[:-1] + (2, 2))
    du0_dp = inv_z[..., None, None] * torch.cat((eye2, -u0[..., :, None]), -1)
    dp_drot = R[..., None, :, :] @ skew_symmetric(pts3d).transpose(-1, -2)
    duv_dp = K22[..., None, :, :] @ du0_dp                       # (..., N, 2, 3)
    J = torch.cat((duv_dp @ dp_drot, duv_dp), dim=-1)
    return r, J
