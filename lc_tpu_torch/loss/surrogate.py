"""Surrogate correspondence losses (counterpart of lc_tpu/loss/surrogate.py):
the binary-code BCE with its per-bit difficulty weights, segmentation BCE
and L1, and the sparse keypoint NLL. Channel-last layouts throughout; the
binary-code histogram EMA is explicit state returned to the caller (the
reference keeps it as a module buffer, losses.py:196-216). Inside a
data-parallel context (parallel/mesh.py) the batch means and the
histogram's observation are those of the global batch."""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.layers import at_least_f32
from ..parallel import mesh


def init_bin_histogram(total_bit_cnt: int, device=None) -> torch.Tensor:
    return torch.full((total_bit_cnt,), 0.5, device=device)


def xyz_bin_loss(noc_bin_logits: torch.Tensor, noc_bin_gt: torch.Tensor,
                 msk_vis_logits: torch.Tensor, histogram: torch.Tensor,
                 momentum: float = 0.05) -> tuple[torch.Tensor, torch.Tensor]:
    """ZebraPose binary-code loss with per-bit difficulty weights.

    noc_bin_logits (B, H, W, C) the predicted Gray-code logits; noc_bin_gt
    the same shape, 0/1 targets; msk_vis_logits (B, H, W, 1). The share of
    each bit that disagrees with the GT inside the predicted mask drives an
    EMA histogram, updated outside the graph; softmax(3·min(h, 0.51 − h))
    weights the per-bit BCE of the masked logits (reference Loss_xyz_bin,
    losses.py:196-216). Computed in float32 whatever the logits' dtype
    (float64 for float64 logits, a rounding reference's).
    Returns (loss, new histogram)."""
    logits = at_least_f32(noc_bin_logits)
    with torch.no_grad():
        msk_hard = msk_vis_logits > 0                        # (B, H, W, 1)
        hamm = ((logits > 0) ^ (noc_bin_gt > 0.5)) & msk_hard
        shard = mesh.active()
        if shard is None:
            hist_obs = hamm.sum((0, 1, 2)) / (msk_hard.sum() + 1.0)
        else:
            # numerator and denominator summed over the ranks' rows
            counts = torch.cat((hamm.sum((0, 1, 2)),
                                msk_hard.sum().reshape(1))).to(logits.dtype)
            dist.all_reduce(counts, group=shard.group)
            hist_obs = counts[:-1] / (counts[-1] + 1.0)
        new_hist = histogram * (1.0 - momentum) \
            + hist_obs.to(histogram.dtype) * momentum
        bin_weights = torch.softmax(
            torch.minimum(new_hist, 0.51 - new_hist) * 3.0, -1)
    raw = F.binary_cross_entropy_with_logits(
        logits * msk_hard.to(logits.dtype), noc_bin_gt.to(logits.dtype),
        reduction='none')
    return (mesh.cross_rank_mean(raw.mean((0, 1, 2))) * bin_weights).sum(), \
        new_hist


def seg_bce_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, target)


def seg_l1_loss(logits: torch.Tensor, target: torch.Tensor,
                weight: torch.Tensor | None = None) -> torch.Tensor:
    """|sigmoid(logits) − target| (reference Loss_seg_L1, losses.py:219-236)."""
    err = torch.abs(torch.sigmoid(logits) - target)
    if weight is not None:
        err = err * weight
    return err.mean()


def sparse_kpt_nll_loss(pts2d: torch.Tensor, pts2d_std: torch.Tensor,
                        pts2d_proj: torch.Tensor) -> torch.Tensor:
    """Laplace NLL on keypoints: log σ + |err|/σ (reference losses.py:318-326)."""
    err = torch.abs(pts2d - pts2d_proj)
    return (torch.log(pts2d_std) + err / pts2d_std).mean()
