"""6D pose error metrics, batched (counterpart of lc_tpu/eval/error6d.py).

The ADI nearest-neighbour search is a brute-force pairwise distance: the
|g|²+|e|²−2g·e expansion (one f32 matmul) selects the neighbour and the
distance is recomputed exactly on the selected pair.
"""
from __future__ import annotations

import numpy as np
import torch


def _transform(pts, R, t):
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def add_err(R_est, t_est, R_gt, t_gt, pts):
    """Mean distance between corresponding transformed model points."""
    d = _transform(pts, R_est, t_est) - _transform(pts, R_gt, t_gt)
    return torch.linalg.norm(d, dim=-1).mean(-1)


def adi_err(R_est, t_est, R_gt, t_gt, pts):
    """Mean distance to the nearest estimated point (indistinguishable views)."""
    est = _transform(pts, R_est, t_est)
    gt = _transform(pts, R_gt, t_gt)
    # center both sets: keeps the expansion safe in f32 at ~1e3 mm translations
    center = gt.mean(-2, keepdim=True)
    gt = gt - center
    est = est - center
    d2 = (gt * gt).sum(-1)[..., :, None] + (est * est).sum(-1)[..., None, :] \
        - 2.0 * gt @ est.transpose(-1, -2)
    nn_idx = torch.argmin(d2, -1)
    nearest = torch.gather(est, -2, nn_idx[..., None].expand(gt.shape))
    return torch.linalg.norm(gt - nearest, dim=-1).mean(-1)


def re_err(R_est, R_gt):
    """Rotation geodesic error in degrees (trace as an elementwise sum)."""
    cos = 0.5 * (torch.sum(R_est * R_gt, dim=(-2, -1)) - 1.0)
    return torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))


def te_err(t_est, t_gt):
    return torch.linalg.norm(t_est - t_gt, dim=-1)


def _sym_poses(R_gt, t_gt, sym_R, sym_t):
    """GT poses composed with each symmetry: (..., S, 3, 3), (..., S, 3)."""
    R_sym = R_gt[..., None, :, :] @ sym_R
    t_sym = (R_gt[..., None, :, :] @ sym_t[..., :, None])[..., 0] \
        + t_gt[..., None, :]
    return R_sym, t_sym


def _project(pts, R, t, K):
    h = _transform(pts, R, t) @ K.transpose(-1, -2)
    return h[..., :2] / h[..., 2:3]


def mssd_err(R_est, t_est, R_gt, t_gt, pts, sym_R, sym_t):
    """Maximum Symmetry-aware Surface Distance (BOP'19). sym_R (S, 3, 3),
    sym_t (S, 3): the symmetry transforms, identity included."""
    est = _transform(pts, R_est, t_est)                       # (..., N, 3)
    R_sym, t_sym = _sym_poses(R_gt, t_gt, sym_R, sym_t)
    gt_sym = _transform(pts[..., None, :, :], R_sym, t_sym)   # (..., S, N, 3)
    d = torch.linalg.norm(est[..., None, :, :] - gt_sym, dim=-1)
    return d.amax(-1).amin(-1)


def mspd_err(R_est, t_est, R_gt, t_gt, K, pts, sym_R, sym_t):
    """Maximum Symmetry-aware Projection Distance (BOP'19), in pixels."""
    proj_est = _project(pts, R_est, t_est, K)                 # (..., N, 2)
    R_sym, t_sym = _sym_poses(R_gt, t_gt, sym_R, sym_t)
    proj_sym = _project(pts[..., None, :, :], R_sym, t_sym, K[..., None, :, :])
    d = torch.linalg.norm(proj_est[..., None, :, :] - proj_sym, dim=-1)
    return d.amax(-1).amin(-1)


def proj_err(R_est, t_est, R_gt, t_gt, K, pts):
    """Mean 2D projection distance (Brachmann CVPR'16)."""
    d = _project(pts, R_est, t_est, K) - _project(pts, R_gt, t_gt, K)
    return torch.linalg.norm(d, dim=-1).mean(-1)


def batched_pose_errors(R_est: np.ndarray, t_est: np.ndarray, R_gt: np.ndarray,
                        t_gt: np.ndarray, pts: np.ndarray, chunk: int = 64,
                        device='cpu') -> dict:
    """Host API: numpy in/out, computed on `device` in chunks of instances to
    bound the (B, N, N) ADI intermediate. pts (N, 3) shared, or (B, N, 3)."""
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                     device=device)
    outs = []
    for i in range(0, len(R_est), chunk):
        sl = slice(i, min(i + chunk, len(R_est)))
        p = as_t(pts[sl] if pts.ndim == 3 else pts)
        Re, te, Rg, tg = (as_t(a[sl]) for a in (R_est, t_est, R_gt, t_gt))
        outs.append(dict(add=add_err(Re, te, Rg, tg, p),
                         adi=adi_err(Re, te, Rg, tg, p),
                         re=re_err(Re, Rg), te=te_err(te, tg)))
    return {k: torch.cat([o[k] for o in outs]).cpu().numpy() for k in outs[0]}
