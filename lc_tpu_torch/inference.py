"""Inference-time PnP solving: decode -> point selection -> RANSAC -> weighted
LM (counterpart of lc_tpu/inference.py): the dense path and the sparse
keypoint path.

Point selection keeps lc_tpu's validity masks over the fixed dense grid, and
its sort-free quantile: an exact order statistic found by bisection over the
int32 bit pattern of the f32 weights, bit-identical to lc_tpu's mask.
"""
from __future__ import annotations

import torch

from . import resolve_device
from .geom.projection import gen_uv
from .loss.targets import nn_out_to_xyz
from .pnp.ransac import ransac_pnp
from .pnp.solver import lm_refine_auto


def _order_stat_bisect(w: torch.Tensor, k: torch.Tensor, iters: int = 34
                       ) -> torch.Tensor:
    """Exact k-th smallest (0-indexed) of w (B, N) per row, without sorting:
    bisection over the sign-folded int32 bit pattern of the f32 values, whose
    integer order is the float order."""
    wi = w.to(torch.float32).contiguous().view(torch.int32)
    fold = torch.tensor(0x7FFFFFFF, dtype=torch.int32, device=w.device)
    key = wi ^ torch.where(wi < 0, fold, torch.zeros_like(fold))
    lo = key.min(-1).values
    hi = key.max(-1).values
    kk = k.to(torch.int32)
    for _ in range(iters):
        # overflow-safe floor average of two int32s of arbitrary sign
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        cnt = (key <= mid[..., None]).sum(-1)
        go_up = cnt <= kk
        lo, hi = torch.where(go_up, mid + 1, lo), torch.where(go_up, hi, mid)
    inside = key <= hi[..., None]
    return torch.where(inside, w, -torch.inf).max(-1).values


def quantile_mask_bisect(den_inv_std2d: torch.Tensor, quantile) -> torch.Tensor:
    """Keep points whose summed weight is >= the per-sample quantile (numpy
    'linear' interpolation semantics). den_inv_std2d: (B, N, 2); quantile
    scalar or (B,). Returns (B, N) bool."""
    w = den_inv_std2d.sum(-1)
    n = w.shape[-1]
    q = torch.as_tensor(quantile, dtype=w.dtype, device=w.device)
    if q.dim() == 0:
        q = q.expand(w.shape[:1])
    pos = q * (n - 1)
    lo_r = torch.clamp(torch.floor(pos).to(torch.int32), 0, n - 1)
    hi_r = torch.clamp(lo_r + 1, 0, n - 1)
    frac = pos - lo_r.to(w.dtype)
    v_lo = _order_stat_bisect(w, lo_r)
    # values <= v_lo fill sorted positions 0..cnt_le-1, so rank hi_r is v_lo
    # again or the smallest value strictly above it
    cnt_le = (w <= v_lo[..., None]).sum(-1)
    next_up = torch.where(w > v_lo[..., None], w, torch.inf).min(-1).values
    v_hi = torch.where((hi_r == lo_r) | (cnt_le > hi_r), v_lo, next_up)
    thresh = v_lo * (1 - frac) + v_hi * frac
    return w >= thresh[..., None]


def dense_grid_outputs(out: dict, gt: dict, *, bit_cnt=None,
                       black_background: bool = False, sample: int = 2) -> dict:
    """Decode the dense head (NOC or Gray-code logits) into flat
    correspondences on the stride-`sample` grid (top-left (0, 0))."""
    nn_out = out.get('xyz_noc', out.get('xyz_noc_bin'))
    xyz = nn_out_to_xyz(nn_out, gt['noc_scale'], bit_cnt=bit_cnt,
                        model_transform=gt.get('model_transform'),
                        black_background=black_background, inference=True)
    wl = out['xyz_weight_logits']                              # (B, h, w, 2)
    B, h, w = wl.shape[:3]
    weights = torch.softmax(wl.reshape(B, -1), -1).reshape(wl.shape) \
        * out['xyz_weights_scale']
    seg = torch.sigmoid(out['msk_vis_logits'][..., 0])
    uv = gen_uv((h, w), device=wl.device).expand(B, h, w, 2)
    sl = (slice(None), slice(0, None, sample), slice(0, None, sample))
    uv = uv[sl]
    n = uv.shape[1] * uv.shape[2]
    return dict(pts2d=uv.reshape(B, n, 2).contiguous(),
                pts3d=xyz[sl].reshape(B, n, 3).contiguous(),
                inv_std2d=weights[sl].reshape(B, n, 2).contiguous(),
                seg_prob=seg[sl].reshape(B, n))


def select_points(inv_std2d: torch.Tensor, seg_prob: torch.Tensor,
                  point_select: str = 'quantile', quantile: float = 0.3,
                  seg_thresh: float = 0.5) -> torch.Tensor:
    """The points PnP takes, (B, N) bool: those in the visibility mask
    ('mask'), those above the weight quantile ('quantile'), or those of the
    mask above the quantile of the mask's weights ('quantile_in_mask')."""
    seg_valid = seg_prob > seg_thresh
    if point_select == 'mask':
        return seg_valid
    if point_select == 'quantile':
        return quantile_mask_bisect(inv_std2d, quantile)
    if point_select == 'quantile_in_mask':
        vis_ratio = seg_valid.to(torch.float32).mean(-1)
        q = 1.0 - (1.0 - quantile) * vis_ratio
        return quantile_mask_bisect(
            inv_std2d * seg_valid[..., None].to(inv_std2d.dtype), q) \
            & seg_valid
    raise ValueError(point_select)


def _on_device(out: dict, gt: dict, device) -> tuple[dict, dict]:
    device = resolve_device(device)
    return ({k: v.to(device) for k, v in out.items()},
            {k: v.to(device) if torch.is_tensor(v) else v
             for k, v in gt.items()})


def solve_pnp_dense(out: dict, gt: dict, generator: torch.Generator | None = None,
                    *, bit_cnt=None, black_background: bool = False,
                    sample: int = 2,
                    point_select: str = 'quantile', quantile: float = 0.3,
                    seg_thresh: float = 0.5, solvers=('weighted',),
                    reproj_err=None, max_iter: int = 50, device=None,
                    sample_idx: torch.Tensor | None = None,
                    global_rows: int | None = None) -> dict:
    """Returns {solver_name: pose7 (B, 7)}.

    Runs on `device` (CUDA unless 'cpu' is passed); the inputs are moved
    there. `generator` draws the RANSAC samples (a data-parallel rank's
    for a global batch of `global_rows`, pnp/ransac.draw_samples);
    `sample_idx` (B, K, 6) replaces that draw with given indices.
    """
    out, gt = _on_device(out, gt, device)
    d = dense_grid_outputs(out, gt, bit_cnt=bit_cnt,
                           black_background=black_background, sample=sample)
    pts2d, pts3d, inv_std = d['pts2d'], d['pts3d'], d['inv_std2d']
    inv_cov2d = inv_std ** 2
    valid = select_points(inv_std, d['seg_prob'], point_select, quantile,
                          seg_thresh)
    thr = 3.0 if reproj_err is None else reproj_err
    rr = ransac_pnp(gt['out_K'], pts3d, pts2d, generator, valid=valid,
                    reproj_threshold=thr, sample_idx=sample_idx,
                    global_rows=global_rows)

    results = {}
    if 'ransac' in solvers:
        results['ransac'] = rr.pose7
    if 'weighted' in solvers:
        results['weighted'] = lm_refine_auto(
            rr.pose7, gt['out_K'], pts3d, pts2d, inv_cov2d, valid=valid,
            max_iter=max_iter).pose7
    if 'weighted_filtered' in solvers:
        results['weighted-filtered'] = lm_refine_auto(
            rr.pose7, gt['out_K'], pts3d, pts2d, inv_cov2d,
            valid=valid & rr.inliers, max_iter=max_iter).pose7
    return results


def solve_pnp_sparse(out: dict, gt: dict,
                     generator: torch.Generator | None = None, *,
                     solvers=('ransac', 'weighted'), reproj_err=None,
                     max_iter: int = 50, device=None,
                     sample_idx: torch.Tensor | None = None,
                     global_rows: int | None = None) -> dict:
    """The sparse keypoint path: out['pts2d'] and out['pts2d_std'] (B, K, 2)
    against the model keypoints gt['pts3d'] (B, K, 3); every keypoint takes
    part (no validity mask), weighted by 1/std². Returns {solver_name:
    pose7 (B, 7)}; `device`, `sample_idx` and `global_rows` as in
    solve_pnp_dense."""
    out, gt = _on_device(out, gt, device)
    pts2d = out['pts2d']
    inv_cov2d = 1.0 / out['pts2d_std'] ** 2
    thr = 2.0 if reproj_err is None else reproj_err
    rr = ransac_pnp(gt['out_K'], gt['pts3d'], pts2d, generator,
                    reproj_threshold=thr, sample_idx=sample_idx,
                    global_rows=global_rows)
    results = {}
    if 'ransac' in solvers:
        results['ransac'] = rr.pose7
    if 'weighted' in solvers:
        results['weighted'] = lm_refine_auto(
            rr.pose7, gt['out_K'], gt['pts3d'], pts2d, inv_cov2d,
            max_iter=max_iter).pose7
    return results
