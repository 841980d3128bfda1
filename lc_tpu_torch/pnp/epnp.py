"""Batched EPnP (Lepetit et al.), OpenCV's SOLVEPNP_EPNP equivalent
(counterpart of lc_tpu/pnp/epnp.py).

Control points from the weighted PCA frame, barycentric coordinates via a 3x3
inverse, the 12x12 near-null space by inverse subspace iteration, the N=1 β
with a 4-β Gauss-Newton refinement on the six inter-control-point distances,
and pose recovery by Procrustes with a Newton–Schulz polar factor.
"""
from __future__ import annotations

import torch

from ..geom.rotations import matrix_to_quaternion
from ..ops.smallmat import (chol_solve, inv3, jacobi_eigh_small, rot_pts,
                            smallest_eigvecs)

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _control_points(pts3d: torch.Tensor, w: torch.Tensor, sweeps: int = 8
                    ) -> torch.Tensor:
    """(..., N, 3), (..., N) -> 4 control points (..., 4, 3): centroid + PCA axes."""
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    c0 = torch.sum(pts3d * w[..., None], -2) / wsum
    centered = (pts3d - c0[..., None, :]) * torch.sqrt(w)[..., None]
    cov = centered.transpose(-1, -2) @ centered / wsum[..., None]
    eigval, eigvec = jacobi_eigh_small(cov, sweeps=sweeps)     # ascending
    scale = torch.sqrt(torch.clamp(eigval, min=1e-9))
    axes = eigvec.transpose(-1, -2) * scale[..., None]         # rows = axes
    return torch.cat((c0[..., None, :], c0[..., None, :] + axes), -2)


def _barycentric(pts3d: torch.Tensor, ctrl: torch.Tensor) -> torch.Tensor:
    """alphas (..., N, 4) with Σα = 1 and pts = Σ α_j ctrl_j."""
    basis = ctrl[..., 1:, :] - ctrl[..., 0:1, :]
    rel = pts3d - ctrl[..., 0:1, :]
    beta = rot_pts(rel, inv3(basis.transpose(-1, -2)))
    alpha0 = 1.0 - beta.sum(-1, keepdim=True)
    return torch.cat((alpha0, beta), -1)


def _dists6(c: torch.Tensor) -> torch.Tensor:
    """Six pairwise distances of 4 points (..., 4, 3) -> (..., 6)."""
    return torch.stack([torch.linalg.norm(c[..., i, :] - c[..., j, :], dim=-1)
                        for i, j in _PAIRS], -1)


def epnp(cam_K: torch.Tensor, pts3d: torch.Tensor, pts2d: torch.Tensor,
         w: torch.Tensor | None = None, gn_iters: int = 8, eig_iters: int = 6,
         cp_sweeps: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """EPnP pose. cam_K (..., 3, 3); pts3d (..., N, 3); pts2d (..., N, 2);
    w (..., N) weights/mask. Returns (pose7 (..., 7), ok (...))."""
    if w is None:
        w = torch.ones(pts2d.shape[:-1], dtype=pts2d.dtype, device=pts2d.device)
    fx = cam_K[..., 0, 0][..., None]
    fy = cam_K[..., 1, 1][..., None]
    cx = cam_K[..., 0, 2][..., None]
    cy = cam_K[..., 1, 2][..., None]

    ctrl_w = _control_points(pts3d, w, sweeps=cp_sweeps)
    a = _barycentric(pts3d, ctrl_w)                             # (..., N, 4)

    # rows Σ_j α_j [f_x x_j + (c_x - u) z_j] = 0 (and the v row); unknowns are
    # the camera-frame control points in the order (x1..x4, y1..y4, z1..z4)
    u = pts2d[..., 0]
    v = pts2d[..., 1]
    zeros = torch.zeros_like(a)
    row_u = torch.cat((a * fx[..., None], zeros, a * (cx - u)[..., None]), -1)
    row_v = torch.cat((zeros, a * fy[..., None], a * (cy - v)[..., None]), -1)
    M = torch.cat((row_u, row_v), -2)                           # (..., 2N, 12)
    wr = torch.cat((w, w), -1)
    MtM = (M * wr[..., None]).transpose(-1, -2) @ M             # (..., 12, 12)

    V, _ = smallest_eigvecs(MtM, 4, iters=eig_iters)            # (..., 12, 4)
    # camera control candidates per basis vector k: (..., 4(k), 4(pt), 3)
    Vc = torch.stack([V[..., k].reshape(V.shape[:-2] + (3, 4)).transpose(-1, -2)
                      for k in range(4)], -3)

    d_w = _dists6(ctrl_w)
    d_v = _dists6(Vc[..., 0, :, :])
    beta1 = torch.sum(d_v * d_w, -1) / torch.clamp(torch.sum(d_v * d_v, -1),
                                                   min=1e-12)
    zero = torch.zeros_like(beta1)
    betas = torch.stack([beta1, zero, zero, zero], -1)

    # Gauss-Newton on the 6 distance constraints over the 4 betas
    diffs = torch.stack([Vc[..., :, i, :] - Vc[..., :, j, :]
                         for i, j in _PAIRS], -3)               # (..., 6, 4k, 3)
    eye4 = torch.eye(4, dtype=V.dtype, device=V.device)
    for _ in range(gn_iters):
        e = torch.einsum('...k,...pkd->...pd', betas, diffs)
        r = torch.sum(e * e, -1) - d_w ** 2
        J = 2.0 * torch.einsum('...pd,...pkd->...pk', e, diffs)
        JtJ = J.transpose(-1, -2) @ J + 1e-9 * eye4
        Jtr = torch.sum(J * r[..., None], -2)
        db, _ = chol_solve(JtJ, Jtr)
        betas = betas - torch.nan_to_num(db)

    ctrl_c = torch.einsum('...k,...kpd->...pd', betas, Vc)      # (..., 4, 3)
    # cheirality: the weighted centroid must be in front of the camera
    depth = (a @ ctrl_c)[..., 2]
    mean_z = torch.sum(depth * w, -1)
    ctrl_c = ctrl_c * torch.where(mean_z < 0, -1.0, 1.0)[..., None, None]

    # Procrustes world->camera on the 4 control points (equal weights)
    from .ransac import _det3, _polar_rotation
    mu_w = ctrl_w.mean(-2, keepdim=True)
    mu_c = ctrl_c.mean(-2, keepdim=True)
    H = (ctrl_c - mu_c).transpose(-1, -2) @ (ctrl_w - mu_w)
    R = _polar_rotation(H)
    ok = _det3(R) > 0
    t = mu_c[..., 0, :] - torch.sum(R * mu_w[..., 0, None, :], -1)
    pose = torch.cat((matrix_to_quaternion(R), t), -1)
    # degenerate samples can blow the barycentric inverse up into inf/NaN:
    # scrub to a benign pose and fold into ok so consensus rejects it
    finite = torch.isfinite(pose).all(-1)
    return torch.where(finite[..., None], pose, _identity_pose(pose)), ok & finite


def _identity_pose(like: torch.Tensor) -> torch.Tensor:
    """The benign (identity rotation, t = (0, 0, 1)) pose, shaped like `like`."""
    p = torch.zeros_like(like)
    p[..., 0] = 1.0
    p[..., 6] = 1.0
    return p
