"""The 7-vector pose (wijk quaternion + xyz translation); counterpart of
lc_tpu/geom/pose.py."""
from __future__ import annotations

import torch

from .rotations import (axis_angle_to_quaternion_near_zero, matrix_to_quaternion,
                        quaternion_raw_multiply, quaternion_to_matrix)


def pose7_to_RT(pose7: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 7) wijk_xyz -> R (..., 3, 3), t (..., 3)."""
    return quaternion_to_matrix(pose7[..., :4]), pose7[..., 4:7]


def RT_to_pose7(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """R (..., 3, 3), t (..., 3) -> (..., 7) wijk_xyz."""
    return torch.cat((matrix_to_quaternion(R), t), dim=-1)


def apply_perturb(pose7: torch.Tensor, d_aax_xyz: torch.Tensor) -> torch.Tensor:
    """Right-perturb a pose: R' = R @ R(δ_rot), t' = t + δ_t, with δ_rot
    through the Taylor chart."""
    q = quaternion_raw_multiply(
        pose7[..., :4], axis_angle_to_quaternion_near_zero(d_aax_xyz[..., :3]))
    return torch.cat((q, pose7[..., 4:7] + d_aax_xyz[..., 3:6]), dim=-1)
