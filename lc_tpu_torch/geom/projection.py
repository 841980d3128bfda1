"""Pinhole projection (counterpart of lc_tpu/geom/projection.py)."""
from __future__ import annotations

import torch


def project_apply(cam_K: torch.Tensor, pts3d: torch.Tensor,
                  R: torch.Tensor | None = None, t: torch.Tensor | None = None,
                  min_z: float = 0.1) -> torch.Tensor:
    """Project 3D points with an optional rigid transform.

    cam_K: (..., 3, 3); pts3d: (..., N, 3); R: (..., 3, 3); t: (..., 3).
    Returns (..., N, 2). z is clamped to min_z before the division.
    """
    if R is not None:
        pts3d = pts3d @ R.transpose(-1, -2) + t[..., None, :]
    h = pts3d @ cam_K.transpose(-1, -2)
    z = torch.clamp(h[..., 2:3], min=min_z)
    return h[..., :2] / z


def gen_uv(shape_hw, dtype=torch.float32, device=None) -> torch.Tensor:
    """Pixel grid: (H, W, 2) with uv[y, x] = (x, y)."""
    H, W = shape_hw[-2:]
    y, x = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                          torch.arange(W, dtype=dtype, device=device),
                          indexing='ij')
    return torch.stack((x, y), dim=-1)


def xyz_from_homo_z(homo_z: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                    cam_K: torch.Tensor) -> torch.Tensor:
    """Backproject depth-scaled homogeneous pixels into the model frame.

    homo_z: (..., P, 3) rows of (u·z, v·z, z) in camera pixels; R, t: the
    model-to-camera pose; cam_K: (..., 3, 3). Returns (..., P, 3):
    Rᵀ (K⁻¹ h − t)."""
    cam_pts = homo_z @ torch.linalg.inv(cam_K).transpose(-1, -2)
    return (cam_pts - t[..., None, :]) @ R
