"""Rotation representation conversions (counterpart of lc_tpu/geom/rotations.py).

Branch-free, batched over arbitrary leading dims, f32. Quaternions are
(w, i, j, k) ("wijk").
"""
from __future__ import annotations

import torch


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions. a, b: (..., 4) wijk -> (..., 4)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack((
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ), dim=-1)


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Flip sign so the real part is non-negative."""
    return torch.where(q[..., :1] < 0, -q, q)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) wijk -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    s = 2.0 / torch.sum(q * q, dim=-1)  # == 2 for unit quats; robust otherwise
    xx, yy, zz = s * x * x, s * y * y, s * z * z
    xy, xz, yz = s * x * y, s * x * z, s * y * z
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    m = torch.stack((
        1.0 - (yy + zz), xy - wz, xz + wy,
        xy + wz, 1.0 - (xx + zz), yz - wx,
        xz - wy, yz + wx, 1.0 - (xx + yy),
    ), dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wijk.

    Branch-free Shepperd's method: build the four candidate quaternions (one
    per largest diagonal term) and keep the numerically best one.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs = torch.stack((
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ), dim=-1)
    q_abs = torch.sqrt(torch.clamp(q_abs, min=0.0))

    cand_w = torch.stack((q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01), -1)
    cand_x = torch.stack((m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20), -1)
    cand_y = torch.stack((m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21), -1)
    cand_z = torch.stack((m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2), -1)
    cands = torch.stack((cand_w, cand_x, cand_y, cand_z), dim=-2)  # (..., 4, 4)

    eps = torch.finfo(m.dtype).eps
    denom = 2.0 * torch.clamp(q_abs, min=0.1 * eps)
    cands = cands / denom[..., None]

    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return standardize_quaternion(q / torch.linalg.norm(q, dim=-1, keepdim=True))


def axis_angle_to_quaternion(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> quaternion (..., 4) wijk, smooth at aa = 0."""
    angle = torch.linalg.norm(aa, dim=-1, keepdim=True)
    half = 0.5 * angle
    small = angle < 1e-4
    sin_half_over = torch.where(
        small, 0.5 - (angle * angle) / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(angle), angle))
    return torch.cat((torch.cos(half), aa * sin_half_over), dim=-1)


def axis_angle_to_quaternion_near_zero(aa: torch.Tensor) -> torch.Tensor:
    """Taylor-expanded axis-angle -> quaternion: the local chart for pose
    perturbations, exact to third order at aa = 0."""
    sq = torch.sum(aa * aa, dim=-1, keepdim=True)
    return torch.cat((1.0 - sq / 8.0, aa * (0.5 - sq / 48.0)), dim=-1)


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(aa))


def skew_symmetric(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> skew-symmetric (..., 3, 3) such that skew(v) @ p = v × p."""
    a0, a1, a2 = v.unbind(-1)
    zero = torch.zeros_like(a0)
    rows = torch.stack((zero, -a2, a1,
                        a2, zero, -a0,
                        -a1, a0, zero), dim=-1)
    return rows.reshape(v.shape[:-1] + (3, 3))
