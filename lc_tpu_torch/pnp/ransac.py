"""Batched RANSAC PnP initializer — the cv2.solvePnPRansac replacement
(counterpart of lc_tpu/pnp/ransac.py).

Every minimal sample is solved by three estimators with complementary
degeneracy regimes (EPnP, the planar homography, the ridge DLT), all
competing in one consensus pool scored on a ≤256-point subset of the valid
points. The hypothesis stage branches on the device as lc_tpu's does on its
backend (lc_tpu/pnp/ransac.py:305): on the card every sample is solved by
lc_tpu's accelerator branch, fast_minimal's scalar-struct solvers, as one
CUDA kernel (pnp/minimal6_kernel.py); on the CPU by lc_tpu's CPU branch, the
generic estimators in their cheap hypothesis mode (`generic_hypotheses`).
The two branches agree statistically, not bit for bit. The winner goes
through threshold-annealed local optimization: EPnP, planar, DLT and
planar-flip refits on the 2×-threshold support, then a short LM polish (10
iterations, the fused kernel on the card) in each of the two rounds, each
candidate kept only if it lowers the MSAC score; the refits use the generic
estimators on both devices, as lc_tpu's do.

Sampling: lc_tpu draws its samples with jax.random (Gumbel top-k), whose bits
torch cannot reproduce. Here samples come from a `torch.Generator`, or from
`sample_idx` when a caller (a parity test) supplies lc_tpu's indices.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom.rotations import (axis_angle_to_matrix, matrix_to_quaternion,
                              quaternion_to_matrix)
from ..ops.smallmat import chol_solve, jacobi_eigh_small, rot_pts
from ..parallel import mesh
from .epnp import _identity_pose, epnp


def _det3(M):
    """Closed-form 3x3 determinant."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


class RansacResult(NamedTuple):
    pose7: torch.Tensor        # (B, 7)
    invalid: torch.Tensor      # (B,) bool
    inliers: torch.Tensor      # (B, N) bool, support of the final pose
    n_inliers: torch.Tensor    # (B,)


def _polar_rotation(M: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Orthogonal polar factor of (..., 3, 3) by Newton–Schulz iteration."""
    norm = torch.linalg.norm(M, dim=(-2, -1), keepdim=True)
    X = M / torch.clamp(norm, min=1e-20)
    for _ in range(iters):
        X = 1.5 * X - 0.5 * (X @ X.transpose(-1, -2)) @ X
    return X


def _ones_like_w(pts2d, w):
    if w is None:
        return torch.ones(pts2d.shape[:-1], dtype=pts2d.dtype,
                          device=pts2d.device)
    return w


def dlt_pnp(cam_K: torch.Tensor, pts3d: torch.Tensor, pts2d: torch.Tensor,
            w: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Direct linear transform PnP with P[2,3] fixed to 1: an 11-unknown
    weighted least squares on normalized 3D points. Returns (pose7, ok)."""
    w = _ones_like_w(pts2d, w)
    inv_K = torch.linalg.inv(cam_K)
    ones = torch.ones_like(pts2d[..., :1])
    xy_norm = rot_pts(torch.cat((pts2d, ones), -1), inv_K)[..., :2]

    # center + unit-RMS scale the 3D points so AᵀA is well conditioned in f32
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-6)
    c3d = torch.sum(pts3d * w[..., None], -2, keepdim=True) / wsum[..., None]
    Xc = pts3d - c3d
    s3d = torch.sqrt(torch.sum(torch.sum(Xc * Xc, -1) * w, -1, keepdim=True)
                     / wsum / 3.0)
    s3d = torch.clamp(s3d, min=1e-6)
    Xn = Xc / s3d[..., None]

    Xh = torch.cat((Xn, ones), -1)
    zeros = torch.zeros_like(Xh)
    u = xy_norm[..., 0:1]
    v = xy_norm[..., 1:2]
    A = torch.cat((torch.cat((Xh, zeros, -u * Xn), -1),
                   torch.cat((zeros, Xh, -v * Xn), -1)), -2)    # (..., 2N, 11)
    b = torch.cat((xy_norm[..., 0], xy_norm[..., 1]), -1)
    Aw = A * torch.cat((w, w), -1)[..., None]
    AtA = Aw.transpose(-1, -2) @ A + 1e-8 * torch.eye(
        11, dtype=A.dtype, device=A.device)
    Atb = torch.sum(Aw * b[..., None], -2)
    x, chol_ok = chol_solve(AtA, Atb)

    # solved P' = λ'[R | t'] for X' = (X - c)/s: λ' = λ·s, t = t'/λ − R·c
    M = torch.stack((x[..., 0:3], x[..., 4:7], x[..., 8:11]), -2)
    t_vec = torch.stack((x[..., 3], x[..., 7], torch.ones_like(x[..., 3])), -1)
    R = _polar_rotation(M)
    lam = torch.sum(R * M, dim=(-2, -1)) / 3.0 / s3d[..., 0]
    ok = chol_ok & (lam > 1e-12) & (_det3(R) > 0)
    Rc = torch.sum(R * c3d[..., 0, None, :], -1)
    t = t_vec / torch.clamp(lam, min=1e-12)[..., None] - Rc
    return torch.cat((matrix_to_quaternion(R), t), -1), ok


def planar_pnp(cam_K: torch.Tensor, pts3d: torch.Tensor, pts2d: torch.Tensor,
               w: torch.Tensor | None = None, pca_sweeps: int = 8
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pose for (near-)planar point sets: the image↔plane homography in the
    weighted-PCA plane frame by ridge least squares, decomposed Zhang-style.
    Returns (pose7, ok)."""
    w = _ones_like_w(pts2d, w)
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    c = torch.sum(pts3d * w[..., None], -2) / wsum
    rel = pts3d - c[..., None, :]
    cov = (rel * w[..., None]).transpose(-1, -2) @ rel
    _, evec = jacobi_eigh_small(cov, sweeps=pca_sweeps)
    b1 = evec[..., :, 2]
    b2 = evec[..., :, 1]
    q1 = torch.sum(rel * b1[..., None, :], -1)
    q2 = torch.sum(rel * b2[..., None, :], -1)
    qs = torch.sqrt(torch.clamp(torch.sum((q1 * q1 + q2 * q2) * w, -1,
                                          keepdim=True) / wsum / 2.0, min=1e-12))
    q1n = q1 / qs
    q2n = q2 / qs

    inv_K = torch.linalg.inv(cam_K)
    ones = torch.ones_like(pts2d[..., :1])
    xy = rot_pts(torch.cat((pts2d, ones), -1), inv_K)[..., :2]
    x = xy[..., 0]
    y = xy[..., 1]
    one = torch.ones_like(q1n)
    zero = torch.zeros_like(q1n)
    # rows for H (8 unknowns, H[2,2]=1): [q1 q2 1 0 0 0 -x q1 -x q2]·h = x
    ru = torch.stack((q1n, q2n, one, zero, zero, zero, -x * q1n, -x * q2n), -1)
    rv = torch.stack((zero, zero, zero, q1n, q2n, one, -y * q1n, -y * q2n), -1)
    A = torch.cat((ru, rv), -2)
    b = torch.cat((x, y), -1)
    Aw = A * torch.cat((w, w), -1)[..., None]
    AtA = Aw.transpose(-1, -2) @ A + 1e-8 * torch.eye(
        8, dtype=A.dtype, device=A.device)
    Atb = torch.sum(Aw * b[..., None], -2)
    h, chol_ok = chol_solve(AtA, Atb)

    h1 = torch.stack((h[..., 0], h[..., 3], h[..., 6]), -1)
    h2 = torch.stack((h[..., 1], h[..., 4], h[..., 7]), -1)
    h3 = torch.stack((h[..., 2], h[..., 5], torch.ones_like(h[..., 0])), -1)
    # λ0 = 2/(‖h1‖+‖h2‖) recovers unit rotation columns; T = λ0·qs·h3
    lam = 2.0 / torch.clamp(torch.linalg.norm(h1, dim=-1)
                            + torch.linalg.norm(h2, dim=-1), min=1e-12)
    r1 = lam[..., None] * h1
    r2 = lam[..., None] * h2
    R_p = _polar_rotation(torch.stack((r1, r2, torch.cross(r1, r2, dim=-1)), -1))
    t_p = lam[..., None] * h3
    Bf = torch.stack((b1, b2, torch.cross(b1, b2, dim=-1)), -1)
    R_w = R_p @ Bf.transpose(-1, -2)
    t_w = t_p * qs - torch.sum(R_w * c[..., None, :], -1)
    ok = chol_ok & (_det3(R_w) > 0) & (t_w[..., 2] > 0)
    pose = torch.cat((matrix_to_quaternion(R_w), t_w), -1)
    finite = torch.isfinite(pose).all(-1)
    return torch.where(finite[..., None], pose, _identity_pose(pose)), ok & finite


def _planar_flip(pose7: torch.Tensor, pts3d: torch.Tensor, w: torch.Tensor
                 ) -> torch.Tensor:
    """The other solution of the two-fold planar-pose ambiguity: mirror the
    camera-frame plane normal across the viewing ray of the centroid and pivot
    the pose about the camera-frame centroid."""
    R = quaternion_to_matrix(pose7[..., :4])
    t = pose7[..., 4:7]
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    c = torch.sum(pts3d * w[..., None], -2) / wsum
    rel = pts3d - c[..., None, :]
    cov = (rel * w[..., None]).transpose(-1, -2) @ rel
    _, evec = jacobi_eigh_small(cov)
    n_c = torch.sum(R * evec[..., None, :, 0], -1)       # R @ plane normal
    cc = torch.sum(R * c[..., None, :], -1) + t
    v = cc / torch.clamp(torch.linalg.norm(cc, dim=-1, keepdim=True), min=1e-9)
    n2 = 2.0 * torch.sum(v * n_c, -1, keepdim=True) * v - n_c
    axis = torch.cross(n_c, n2, dim=-1)
    s = torch.linalg.norm(axis, dim=-1)
    ang = torch.atan2(s, torch.sum(n_c * n2, -1))
    aa = axis / torch.clamp(s, min=1e-9)[..., None] * ang[..., None]
    R2 = axis_angle_to_matrix(aa) @ R
    t2 = cc - torch.sum(R2 * c[..., None, :], -1)
    return torch.cat((matrix_to_quaternion(R2), t2), -1)


def _reproj_err(pose_R, pose_t, cam_K, pts3d, pts2d):
    cam = rot_pts(pts3d, pose_R) + pose_t[..., None, :]
    h = rot_pts(cam, cam_K)
    uv = h[..., :2] / torch.clamp(h[..., 2:3], min=1e-6)
    err = torch.linalg.norm(uv - pts2d, dim=-1)
    return torch.where(cam[..., 2] <= 0, torch.inf, err)


def draw_samples(valid: torch.Tensor, num_hypotheses: int, sample_size: int,
                 generator: torch.Generator | None = None,
                 global_rows: int | None = None) -> torch.Tensor:
    """`sample_size` distinct valid indices per hypothesis, (B, K, s): the
    top-k of uniform scores, which is a uniform draw without replacement.
    Inside a data-parallel context (parallel/mesh.py) the B problems are
    this rank's slice of a global batch of `global_rows` (B · ranks when
    None; rows past it repeat its last, the padding of an eval batch): the
    scores are drawn for the global batch and this slice kept, so each
    problem sees the same draw at any number of ranks."""
    B, N = valid.shape
    shard = mesh.active()
    if shard is None:
        scores = torch.rand((B, num_hypotheses, N), generator=generator,
                            device=valid.device)
    else:
        n = B * shard.count if global_rows is None else global_rows
        rows = (torch.arange(B, device=valid.device)
                + shard.index * B).clamp(max=n - 1)
        scores = torch.rand((n, num_hypotheses, N), generator=generator,
                            device=valid.device)[rows]
    scores = scores.masked_fill(~valid[:, None, :], -1.0)
    return torch.topk(scores, sample_size, dim=-1).indices


def generic_hypotheses(cam_K: torch.Tensor, sub3d: torch.Tensor,
                       sub2d: torch.Tensor, estimators: tuple
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """lc_tpu's CPU branch of the hypothesis stage (lc_tpu/pnp/ransac.py:
    305-313): the generic estimators in their cheap hypothesis mode on
    cam_K (B, 3, 3), sub3d (B, K, s, 3), sub2d (B, K, s, 2), concatenated
    in the order epnp, planar, dlt: (pose_h (B, nE·K, 7), ok_h (B, nE·K))."""
    Kb = cam_K[:, None]
    cand_h = []
    if 'epnp' in estimators:
        cand_h.append(epnp(Kb, sub3d, sub2d, gn_iters=4, eig_iters=3,
                           cp_sweeps=4))
    if 'planar' in estimators:
        cand_h.append(planar_pnp(Kb, sub3d, sub2d, pca_sweeps=4))
    if 'dlt' in estimators:
        cand_h.append(dlt_pnp(Kb, sub3d, sub2d))
    return (torch.cat([c[0] for c in cand_h], 1),
            torch.cat([c[1] for c in cand_h], 1))


def hypothesis_solver(device: torch.device):
    """The hypothesis stage's solver for tensors on `device`, as lc_tpu
    picks it by backend: the card runs the accelerator branch in the
    minimal6 kernel, the CPU the generic estimators. Both take
    (cam_K, sub3d, sub2d, estimators)."""
    if device.type == 'cuda':
        from .minimal6_kernel import minimal6_cuda
        return minimal6_cuda
    return generic_hypotheses


def ransac_pnp(cam_K: torch.Tensor, pts3d: torch.Tensor, pts2d: torch.Tensor,
               generator: torch.Generator | None = None,
               valid: torch.Tensor | None = None, *,
               reproj_threshold: torch.Tensor | float = 3.0,
               num_hypotheses: int = 150, sample_size: int = 6,
               local_opt: bool = True,
               hyp_estimators: tuple = ('epnp', 'planar', 'dlt'),
               sample_idx: torch.Tensor | None = None,
               global_rows: int | None = None) -> RansacResult:
    """Robust pose init for a batch of correspondence sets.

    cam_K: (B, 3, 3); pts3d: (B, N, 3); pts2d: (B, N, 2); valid: (B, N) mask;
    reproj_threshold: scalar or (B,) pixels; sample_idx: optional (B, K, s)
    sample indices that replace the draw from `generator`; global_rows:
    see draw_samples.
    """
    from .solver import lm_refine_auto

    B, N = pts2d.shape[:2]
    dev = pts2d.device
    if valid is None:
        valid = torch.ones((B, N), dtype=torch.bool, device=dev)
    thr = torch.as_tensor(reproj_threshold, dtype=torch.float32,
                          device=dev).expand(B)

    idx = sample_idx if sample_idx is not None else draw_samples(
        valid, num_hypotheses, sample_size, generator, global_rows)
    idx = idx.to(device=dev, dtype=torch.int64)
    K_h, s = idx.shape[1:]
    sub3d = torch.gather(pts3d[:, None].expand(B, K_h, N, 3), 2,
                         idx[..., None].expand(B, K_h, s, 3))
    sub2d = torch.gather(pts2d[:, None].expand(B, K_h, N, 2), 2,
                         idx[..., None].expand(B, K_h, s, 2))

    pose_h, ok_h = hypothesis_solver(dev)(                   # (B, nE·K, 7)
        cam_K.contiguous(), sub3d, sub2d, hyp_estimators)

    # winner selection on ≤256 points drawn evenly from the valid ones: the
    # j-th target is the (tgt_j+1)-th valid point
    k_sc = min(256, N)
    if k_sc < N:
        cum = torch.cumsum(valid.to(torch.int32), 1)
        n_val = torch.clamp(cum[:, -1], min=1)
        tgt = (torch.arange(k_sc, device=dev)[None, :] * n_val[:, None]) \
            // k_sc + 1
        sel = torch.sum(cum[:, None, :] < tgt[..., None], -1)
        sel = torch.clamp(sel, max=N - 1)
        p3_s = torch.gather(pts3d, 1, sel[..., None].expand(B, k_sc, 3))
        p2_s = torch.gather(pts2d, 1, sel[..., None].expand(B, k_sc, 2))
        v_s = torch.gather(valid, 1, sel)
    else:
        p3_s, p2_s, v_s = pts3d, pts2d, valid
    R_h = quaternion_to_matrix(pose_h[..., :4])
    err = _reproj_err(R_h, pose_h[..., 4:7], cam_K[:, None], p3_s[:, None],
                      p2_s[:, None])
    inl = (err < thr[:, None, None]) & v_s[:, None, :]
    counts = torch.where(ok_h, inl.sum(-1), -1)
    best = torch.argmax(counts, -1)
    pose = torch.gather(pose_h, 1, best[:, None, None].expand(B, 1, 7))[:, 0]

    def msac_score(p7, mult=1.0):
        """Truncated-quadratic score at the final threshold (lower is better)
        and the support mask at mult× the threshold."""
        e = _reproj_err(quaternion_to_matrix(p7[..., :4]), p7[..., 4:7], cam_K,
                        pts3d, pts2d)
        e2 = torch.minimum(e * e, (thr * thr)[:, None])
        e2 = torch.where(valid, e2, 0.0)
        return e2.sum(-1), (e < mult * thr[:, None]) & valid

    def finalize(pose):
        """Support/validity at the exact threshold; a non-finite pose becomes
        the benign identity pose flagged invalid."""
        _, best_inl = msac_score(pose, 1.0)
        n_inl = best_inl.sum(-1)
        finite = torch.isfinite(pose).all(-1)
        return RansacResult(
            pose7=torch.where(finite[:, None], pose, _identity_pose(pose)),
            invalid=(n_inl < 4) | ~finite, inliers=best_inl, n_inliers=n_inl)

    score, cur_inl = msac_score(pose, 2.0)
    if not local_opt:
        return finalize(pose)
    # threshold-annealed LO: round 1 fits on a 2×-threshold band, round 2 on
    # the final threshold; refit candidates only in the wide round
    for mult in (2.0, 1.0):
        if mult == 2.0:
            enough = cur_inl.sum(-1) >= sample_size
            w_inl = cur_inl.to(torch.float32)
            ok_all = torch.ones(pose.shape[:-1], dtype=torch.bool, device=dev)
            for cand, ok_c in (epnp(cam_K, pts3d, pts2d, w_inl),
                               planar_pnp(cam_K, pts3d, pts2d, w_inl),
                               dlt_pnp(cam_K, pts3d, pts2d, w_inl),
                               (_planar_flip(pose, pts3d, w_inl), ok_all)):
                s_c, inl_c = msac_score(cand, mult)
                take = ok_c & enough & (s_c < score)
                pose = torch.where(take[:, None], cand, pose)
                score = torch.where(take, s_c, score)
                cur_inl = torch.where(take[:, None], inl_c, cur_inl)
        # short LM polish on the current support; a problem still descending
        # at the cap ships its last accepted iterate (fallback_to_init=False)
        gn = lm_refine_auto(pose, cam_K, pts3d, pts2d, torch.ones_like(pts2d),
                            valid=cur_inl, max_iter=10, fallback_to_init=False)
        s_b, inl_b = msac_score(gn.pose7, mult)
        take_b = torch.isfinite(gn.pose7).all(-1) & (s_b < score)
        pose = torch.where(take_b[:, None], gn.pose7, pose)
        score = torch.where(take_b, s_b, score)
        cur_inl = torch.where(take_b[:, None], inl_b, cur_inl)
    return finalize(pose)
