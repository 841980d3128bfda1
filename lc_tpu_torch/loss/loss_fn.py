"""Loss orchestration: surrogate and LC pose losses with the ramp and the
gradient taps (counterpart of lc_tpu/loss/loss_fn.py; reference
losses.py:239-386), for the three heads: dense continuous NOC, dense
Gray codes (zebra) and sparse keypoints.

The binary-code histogram and the clip thresholds live in an explicit
LossState; the observed activation-gradient norms come back as the
gradients of 0-d tap tensors (see clip.py) and are folded in by
`finalize_loss_state`. Every mean over the batch is the global batch's
inside a data-parallel context (parallel/mesh.cross_rank_mean).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .clip import ClipperState, clip_threshold, grad_tap, init_clipper_state, \
    update_clipper_state
from .cov_mixed import loss_cov_mixed
from .surrogate import init_bin_histogram, seg_bce_loss, seg_l1_loss, \
    sparse_kpt_nll_loss, xyz_bin_loss
from .targets import nn_out_to_xyz
from ..geom.pose import pose7_to_RT
from ..parallel.mesh import cross_rank_mean
from ..geom.projection import gen_uv, project_apply

TAP_NAMES = ('weight', 'scale', 'pts')


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Static loss hyperparameters (from cfg.loss; see configs/*.yaml)."""
    w_loss_noc: float = 0.0
    w_loss_noc_bin: float = 0.0
    w_loss_seg: float = 0.0
    w_loss_pose: float = 0.0
    w_loss_kpts: float = 0.0
    seg_loss_type: str = 'bce'           # 'bce' | 'l1'
    full_pose_loss_step: int = 0         # max(start_step, start_epoch·steps)
    loss_pose_nz_step: int = 0
    dense_sample: int = 2
    max_err_len: float = 32.0
    cov_2d: bool = False                 # propagate to projected bbox corners
    clip_weight_grad: bool = True
    clip_scale_grad: bool = False
    clip_pts_grad: bool = False
    bit_cnt: tuple | None = None
    black_background: bool = False
    sparse: bool = False


class LossState(NamedTuple):
    histogram: torch.Tensor | None       # (sum(bit_cnt),) for Gray codes
    weight_clip: ClipperState
    scale_clip: ClipperState
    pts_clip: ClipperState


def init_loss_state(cfg: LossConfig | None = None, device=None) -> LossState:
    hist = init_bin_histogram(sum(cfg.bit_cnt), device) \
        if cfg is not None and cfg.bit_cnt else None
    return LossState(hist, *(init_clipper_state(device) for _ in TAP_NAMES))


def loss_state_to(state: LossState, device) -> LossState:
    """The state on `device` (a checkpoint's is loaded on the CPU)."""
    return LossState(
        None if state.histogram is None else state.histogram.to(device),
        *(type(c)(*(t.to(device) for t in c)) for c in state[1:]))


def make_taps(device=None) -> dict:
    """Fresh 0-d leaves whose .grad receives the observed norms."""
    return {k: torch.zeros((), device=device, requires_grad=True)
            for k in TAP_NAMES}


def _strided_grid(x: torch.Tensor, sample: int, top: int, left: int):
    """x (B, H, W, ...) -> (B, h·w, ...) from rows top::sample and cols
    left::sample, floor(H/sample) of each (static shapes, as lc_tpu)."""
    B, H, W = x.shape[:3]
    h, w = H // sample, W // sample
    rows = top + sample * torch.arange(h, device=x.device)
    cols = left + sample * torch.arange(w, device=x.device)
    return x[:, rows][:, :, cols].reshape((B, h * w) + tuple(x.shape[3:]))


def _pose_ramp(cfg: LossConfig, step: int) -> float:
    denom = max(cfg.full_pose_loss_step - cfg.loss_pose_nz_step, 0) + 1e-5
    return min(max((step - cfg.loss_pose_nz_step + 1) / denom, 0.0), 1.0)


def compute_losses(cfg: LossConfig, gt: dict, out: dict, state: LossState,
                   step: int, taps: dict, sample_top_left=(0, 0)):
    """Returns (total_loss, loss_dict, new_state): the histogram of the
    binary-code loss moves here. `taps` are the 0-d leaves whose gradients
    report the observed activation-gradient norms."""
    if cfg.sparse:
        loss_dict, new_hist = _sparse_losses(cfg, gt, out, step), \
            state.histogram
    else:
        loss_dict, new_hist = _dense_losses(cfg, gt, out, state, step, taps,
                                            sample_top_left)
    weights_cfg = {'loss_noc': cfg.w_loss_noc,
                   'loss_noc_bin': cfg.w_loss_noc_bin,
                   'loss_seg': cfg.w_loss_seg, 'loss_pose': cfg.w_loss_pose,
                   'loss_kpts': cfg.w_loss_kpts}
    total = sum(v * weights_cfg[k] for k, v in loss_dict.items()
                if weights_cfg.get(k, 0) > 0)
    return total, loss_dict, state._replace(histogram=new_hist)


def _sparse_losses(cfg: LossConfig, gt: dict, out: dict, step: int) -> dict:
    """The keypoint Laplace NLL against the best pose's projections, and
    the LC loss on the keypoints with 1/std as their weights, ramped in
    from the NLL."""
    pts2d, pts2d_std = out['pts2d'], out['pts2d_std']
    pose_best, K, pts3d = gt['pose_best'], gt['out_K'], gt['pts3d']
    proj = project_apply(K, pts3d, *pose7_to_RT(pose_best))
    loss_kpts = cross_rank_mean(sparse_kpt_nll_loss(pts2d, pts2d_std, proj))
    terms = {'loss_kpts': loss_kpts}
    if cfg.w_loss_pose > 0:
        lc = loss_cov_mixed(K, pose_best, pts3d, pts2d, 1.0 / pts2d_std, None,
                            bbox_3d=gt['bbox_3d'], cov_2d=cfg.cov_2d)
        f = _pose_ramp(cfg, step)
        terms['loss_pose'] = f * cross_rank_mean(lc.mean()) \
            + (1.0 - f) * loss_kpts
    return terms


def _dense_losses(cfg: LossConfig, gt: dict, out: dict, state: LossState,
                  step: int, taps: dict, sample_top_left):
    """The NOC L1 (continuous head) or the binary-code loss (Gray codes),
    the segmentation loss, and the dense LC loss on the strided grid,
    ramped in from the weight logits' segmentation loss. Returns
    (terms, new histogram)."""
    terms: dict[str, torch.Tensor] = {}
    new_hist = state.histogram
    msk_noc, msk_vis = gt['msk_noc'], gt['msk_vis']           # (B, h, w)
    has_bin = cfg.bit_cnt is not None
    if has_bin:
        terms['loss_noc_bin'], new_hist = xyz_bin_loss(
            out['xyz_noc_bin'], gt['xyz_noc_bin_tgt'], out['msk_vis_logits'],
            state.histogram)
    else:
        noc_msked = out['xyz_noc'] * msk_noc[..., None]
        terms['loss_noc'] = cross_rank_mean(
            torch.abs(noc_msked - gt['xyz_noc_tgt']).mean())
    seg_fn = seg_l1_loss if cfg.seg_loss_type.lower() == 'l1' else seg_bce_loss
    terms['loss_seg'] = cross_rank_mean(
        seg_fn(out['msk_vis_logits'], msk_vis[..., None]))

    # the dense LC pose loss
    weight_logits = out['xyz_weight_logits']                  # (B, h, w, 2)
    if cfg.clip_weight_grad:
        weight_logits = grad_tap(weight_logits,
                                 clip_threshold(state.weight_clip),
                                 taps['weight'])
    scale = out['xyz_weights_scale']                          # (B, 1, 1, 1)
    if cfg.clip_scale_grad:
        scale = grad_tap(scale, clip_threshold(state.scale_clip), taps['scale'])
    B, h, w = weight_logits.shape[:3]
    # softmax over the flattened (h·w·2) logits, in channel-last order
    weights_full = torch.softmax(weight_logits.reshape(B, -1), -1) \
        .reshape(weight_logits.shape) * scale

    top, left = sample_top_left
    s = cfg.dense_sample
    uv = gen_uv((h, w), device=weight_logits.device)[None].expand(B, h, w, 2)
    den_pts2d = _strided_grid(uv, s, top, left)
    den_inv_std2d = _strided_grid(weights_full, s, top, left)
    if has_bin:
        # the training decode with the GT's bits. As lc_tpu (and the
        # reference) it decodes inside the GT's NOC mask, not the predicted
        # visibility mask the reference also computes (lc_tpu's
        # loss_fn.py:157)
        den_pts3d = nn_out_to_xyz(
            _strided_grid(out['xyz_noc_bin'], s, top, left), gt['noc_scale'],
            raw_bits_gt=_strided_grid(gt['xyz_noc_bin_raw'].bool(), s, top,
                                      left),
            noc_mask=_strided_grid(msk_noc, s, top, left) > 0.5,
            model_transform=gt.get('model_transform'), bit_cnt=cfg.bit_cnt,
            black_background=cfg.black_background)
    else:
        den_pts3d = _strided_grid(out['xyz_noc'], s, top, left) \
            * gt['noc_scale'][:, None, :]
    if cfg.clip_pts_grad:
        den_pts3d = grad_tap(den_pts3d, clip_threshold(state.pts_clip),
                             taps['pts'])
    den_valid = torch.ones_like(den_pts3d[..., 0])
    lc = loss_cov_mixed(gt['out_K'], gt['pose_best'], den_pts3d, den_pts2d,
                        den_inv_std2d, den_valid, bbox_3d=gt['bbox_3d'],
                        max_err_len=cfg.max_err_len, cov_2d=cfg.cov_2d)
    f = _pose_ramp(cfg, step)
    loss_weight_seg = cross_rank_mean(seg_fn(
        weight_logits, msk_vis[..., None].expand(weight_logits.shape)))
    terms['loss_pose'] = f * cross_rank_mean(lc.mean()) \
        + (1.0 - f) * loss_weight_seg
    return terms, new_hist


def finalize_loss_state(state: LossState, tap_grads: dict,
                        cfg: LossConfig) -> LossState:
    """Fold the observed activation-gradient norms into the clip thresholds."""
    ws = update_clipper_state(state.weight_clip, tap_grads['weight']) \
        if cfg.clip_weight_grad else state.weight_clip
    sc = update_clipper_state(state.scale_clip, tap_grads['scale'],
                              rel_thresh=2.0) if cfg.clip_scale_grad \
        else state.scale_clip
    pt = update_clipper_state(state.pts_clip, tap_grads['pts'],
                              rel_thresh=2.0) if cfg.clip_pts_grad \
        else state.pts_clip
    return LossState(histogram=state.histogram, weight_clip=ws, scale_clip=sc,
                     pts_clip=pt)
