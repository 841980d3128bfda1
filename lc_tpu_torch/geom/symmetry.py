"""Symmetric-object handling (counterpart of lc_tpu/geom/symmetry.py).

Candidate poses are made on the host (numpy, once per sample) and padded to
a fixed count K with a validity mask; the best candidate is selected on the
device (torch).
"""
from __future__ import annotations

import math

import numpy as np
import torch

DATASET_SYMMETRIC_OBJ_IDS = {
    "lm": [3, 7, 10, 11],
    "lmo": [10, 11],
    "tless": list(range(1, 31)),
    "tudl": [],
    "tyol": [3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 15, 16, 17, 18, 19, 21],
    "ruapc": [8, 9, 12, 13],
    "icmi": [1, 2, 6],
    "icbin": [1],
    "itodd": [2, 3, 4, 5, 7, 8, 9, 11, 12, 14, 17, 18, 19, 23, 24, 25, 27, 28],
    "hbs": [10, 12, 18, 29],
    "hb": [6, 10, 11, 12, 13, 14, 18, 24, 29],
    "ycbv": [1, 13, 14, 16, 18, 19, 20, 21],
    "ycbvposecnn": [13, 16, 19, 20, 21],
    "synthetic": [],
    "synthetic_sym": [1],
}


def _axis_angle_matrices(axis: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Rodrigues' formula for one unit axis and a vector of angles: (K, 3, 3)."""
    axis = axis / np.linalg.norm(axis)
    kx, ky, kz = axis
    K = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]], dtype=np.float64)
    sin = np.sin(angles)[:, None, None]
    cos = np.cos(angles)[:, None, None]
    return np.eye(3)[None] + sin * K[None] + (1.0 - cos) * (K @ K)[None]


def symmetry_pose_candidates(base_R: np.ndarray, base_t: np.ndarray,
                             model_info: dict, continuous_steps: int = 384
                             ) -> np.ndarray:
    """All GT-equivalent poses of a symmetric object: (K, 3, 4) float32.

    model_info holds BOP's 'symmetries_discrete' (flat 4x4 lists) or
    'symmetries_continuous' ([{'axis', 'offset'}], discretized into
    `continuous_steps` rotations)."""
    continuous = 'symmetries_continuous' in model_info
    discrete = 'symmetries_discrete' in model_info
    if continuous and discrete:
        raise NotImplementedError('mixed discrete+continuous symmetries')
    if discrete:
        ms = [np.reshape(np.asarray(s, np.float64), (4, 4))
              for s in model_info['symmetries_discrete']]
        xform_Rs = np.stack([np.eye(3)] + [m[:3, :3] for m in ms])
        xform_ts = np.stack([np.zeros(3)] + [m[:3, 3] for m in ms])
    elif continuous:
        syms = model_info['symmetries_continuous']
        if len(syms) != 1:
            raise NotImplementedError('only a single continuous symmetry')
        axis = np.asarray(syms[0]['axis'], np.float64)
        offset = np.asarray(syms[0]['offset'], np.float64)
        angles = np.linspace(0.0, 2.0 * math.pi, continuous_steps,
                             endpoint=False)
        xform_Rs = _axis_angle_matrices(axis, angles)
        xform_ts = offset - xform_Rs @ offset    # rotation about an offset axis
    else:
        xform_Rs, xform_ts = np.eye(3)[None], np.zeros((1, 3))
    candi_Rs = base_R @ xform_Rs
    candi_ts = (base_R @ xform_ts[..., None])[..., 0] + base_t
    return np.concatenate((candi_Rs, candi_ts[..., None]), -1).astype(np.float32)


def pad_candidates(cands: np.ndarray, max_k: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Pad (K, 3, 4) candidates to (max_k, 3, 4) plus a validity mask
    (max_k,); the padding repeats candidate 0, so it ties and never wins."""
    k = cands.shape[0]
    if k > max_k:
        raise ValueError(f'{k} candidates exceed max_k={max_k}')
    pad = np.broadcast_to(cands[:1], (max_k - k, 3, 4))
    return np.concatenate((cands, pad), axis=0), np.arange(max_k) < k


def _pick(pose_candi, err, candi_valid):
    if candi_valid is not None:
        err = torch.where(candi_valid, err, torch.inf)
    best = torch.argmin(err, dim=-1)
    return pose_candi[torch.arange(len(best), device=best.device), best]


def select_pose_2d(cam_K, pts3d, pts2d, pose_candi, candi_valid=None):
    """Per sample, the candidate (B, K, 3, 4) whose projection of pts3d
    (B, N, 3) lies closest to pts2d (B, N, 2) on average. Returns (B, 3, 4)."""
    xf = pts3d[:, None] @ pose_candi[..., :3].transpose(-1, -2) \
        + pose_candi[..., None, :, 3]                       # (B, K, N, 3)
    h = xf @ cam_K[:, None].transpose(-1, -2)
    uv = h[..., :2] / h[..., 2:3]
    err = torch.linalg.norm(uv - pts2d[:, None], dim=-1).mean(-1)
    return _pick(pose_candi, err, candi_valid)


def select_pose_3d(cam_K, pts3d_out, homo_z, pose_candi, candi_valid=None):
    """Per sample, the candidate whose backprojected GT surface homo_z
    (B, N, 3) lies closest to the predicted model points pts3d_out (B, N, 3)
    on average. Returns (B, 3, 4)."""
    cam_pts = homo_z @ torch.linalg.inv(cam_K).transpose(-1, -2)
    R, t = pose_candi[..., :3], pose_candi[..., 3]
    ref = (cam_pts[:, None] - t[..., None, :]) @ R           # Rᵀ(x − t), rows
    err = torch.linalg.norm(pts3d_out[:, None] - ref, dim=-1).mean(-1)
    return _pick(pose_candi, err, candi_valid)
