"""Device-side axis-aligned ROI crop (counterpart of lc_tpu/data/crop.py,
`batched_separable_warp`).

Convention of cv2.warpAffine(dst_size, M): M maps source pixels to destination
pixels, dst(x) = src(M⁻¹x) with bilinear or nearest sampling and zero
outside the source. An axis-aligned crop is a per-sample scale + translate,
so it is separable: out = W_y · img · W_xᵀ per channel, two batched matmuls.
"""
from __future__ import annotations

import torch

from ..geom.affine import invert_affine


def _interp_matrix(inv_a: torch.Tensor, inv_b: torch.Tensor, n_out: int,
                   n_src: int, method: str) -> torch.Tensor:
    """Per-crop 1D resampling matrix (..., n_out, n_src) for
    src_coord = inv_a · out_coord + inv_b: tent weights for bilinear (zero
    outside the source), one-hot at the rounded coordinate for nearest."""
    o = torch.arange(n_out, dtype=torch.float32, device=inv_a.device)[:, None]
    i = torch.arange(n_src, dtype=torch.float32, device=inv_a.device)[None, :]
    src = inv_a[..., None, None] * o + inv_b[..., None, None]
    if method == 'bilinear':
        return torch.clamp(1.0 - torch.abs(src - i), min=0.0)
    return (torch.round(src) == i).to(torch.float32)


def batched_separable_warp(imgs: torch.Tensor, affines: torch.Tensor,
                           out_hw: tuple, method: str = 'bilinear',
                           compute_dtype: torch.dtype | None = None
                           ) -> torch.Tensor:
    """imgs (B, H, W, C), affines (B, 2, 3) without rotation -> (B, h, w, C).

    compute_dtype=torch.bfloat16 runs both matmuls in bf16 (right for 8-bit
    RGB, wrong for depth-scale values); the output keeps the input dtype."""
    h, w = out_hw
    H, W = imgs.shape[1:3]
    inv = invert_affine(affines, xp=torch)
    Wy = _interp_matrix(inv[:, 1, 1], inv[:, 1, 2], h, H, method)  # (B, h, H)
    Wx = _interp_matrix(inv[:, 0, 0], inv[:, 0, 2], w, W, method)  # (B, w, W)
    out_dtype = imgs.dtype
    if compute_dtype is not None:
        imgs, Wy, Wx = (t.to(compute_dtype) for t in (imgs, Wy, Wx))
    tmp = torch.einsum('boh,bhwc->bowc', Wy, imgs)
    out = torch.einsum('bow,bhwc->bhoc', Wx, tmp)
    return out.to(out_dtype)
