"""Surrogate correspondence losses (counterpart of lc_tpu/loss/surrogate.py):
segmentation BCE and L1, and the sparse keypoint NLL. The binary-code loss
arrives with the zebra slice. Channel-last layouts throughout."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
