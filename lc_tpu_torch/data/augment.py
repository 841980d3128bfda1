"""Device-side colour augmentation and background switching (counterpart of
lc_tpu/data/augment.py, the reference's imgaug pipeline).

Salt and pepper, motion blur, coarse dropout, gaussian blur, additive
brightness, invert, two multiplies and linear contrast, each gated by a
per-sample Bernoulli draw, with lc_tpu's probabilities and value ranges, on
float RGB in [0, 255] of shape (B, H, W, 3).

The random values are drawn in one function (`draw_color_aug`, from a
torch.Generator) and applied in another (`apply_color_aug`), so a test can
hand both packages the same values. jax.random's bits cannot be reproduced
in torch: the two pipelines agree in distribution, and exactly where they
are fed the same values. A data-parallel rank draws the values of the
global batch and keeps its own rows, so each crop sees the same draws at
any number of ranks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import mesh

MOTION_DIRS = ((0, 1), (1, 0), (1, 1), (1, -1))  # horizontal, vertical, diagonals


def _uniform(gen, shape, low, high, device):
    return torch.rand(shape, generator=gen, device=device) * (high - low) + low


def _bernoulli(gen, prob, shape, device):
    return torch.rand(shape, generator=gen, device=device) < prob


def _maybe_per_channel(gen, b, prob_pc, low, high, device):
    """(B,1,1,3) values: with probability prob_pc one per channel, else one
    shared by the three channels."""
    per = _uniform(gen, (b, 1, 1, 3), low, high, device)
    shared = _uniform(gen, (b, 1, 1, 1), low, high, device)
    pc = _bernoulli(gen, prob_pc, (b, 1, 1, 1), device)
    return torch.where(pc, per, shared.expand_as(per))


def draw_color_aug(shape, gen: torch.Generator, *, use_pepper_salt=False,
                   use_motion_blur=False, use_invert=False, device=None) -> dict:
    """Every random value the pipeline needs for a (B, H, W, C) batch."""
    B, H, W, _ = shape
    gh, gw = max(int(H * 0.05), 1), max(int(W * 0.05), 1)
    d = {}
    if use_pepper_salt:
        d['sp_gate'] = _bernoulli(gen, 0.3, (B, 1, 1, 1), device)
        d['sp_hit'] = _bernoulli(gen, 0.05, (B, H, W, 1), device)
        d['sp_salt'] = _bernoulli(gen, 0.5, (B, H, W, 1), device)
    if use_motion_blur:
        d['mb_gate'] = _bernoulli(gen, 0.2, (B, 1, 1, 1), device)
        d['mb_dir'] = torch.randint(0, 4, (B,), generator=gen, device=device)
    d['drop_gate'] = _bernoulli(gen, 0.5, (B, 1, 1, 1), device)
    d['drop_keep'] = _bernoulli(gen, 0.9, (B, gh, gw, 1), device)
    d['blur_gate'] = _bernoulli(gen, 0.5, (B, 1, 1, 1), device)
    d['blur_sigma'] = _uniform(gen, (B, 1, 1, 1), 0.0, 1.2, device)
    d['add_gate'] = _bernoulli(gen, 0.5, (B, 1, 1, 1), device)
    d['add'] = _maybe_per_channel(gen, B, 0.3, -25.0, 25.0, device)
    if use_invert:
        d['inv_gate'] = _bernoulli(gen, 0.4, (B, 1, 1, 1), device)
        d['inv_ch'] = _bernoulli(gen, 0.2, (B, 1, 1, 3), device)
    d['mul_gate'] = _bernoulli(gen, 0.5, (B, 1, 1, 1), device)
    d['mul'] = _maybe_per_channel(gen, B, 0.5, 0.6, 1.4, device)
    d['mul2_gate'] = _bernoulli(gen, 0.5, (B, 1, 1, 1), device)
    d['mul2'] = _uniform(gen, (B, 1, 1, 1), 0.6, 1.4, device)
    d['contrast_gate'] = _bernoulli(gen, 0.5, (B, 1, 1, 1), device)
    d['alpha'] = _maybe_per_channel(gen, B, 0.3, 0.5, 2.2, device)
    return d


def gaussian_blur(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """5-tap separable gaussian with per-sample sigma (B,1,1,1) and edge
    padding; sigma -> 0 is the identity."""
    H, W = x.shape[1:3]
    offs = torch.arange(-2.0, 3.0, device=x.device)
    s = torch.clamp(sigma[:, 0, 0, 0], min=1e-3)
    w = torch.exp(-0.5 * (offs[None, :] / s[:, None]) ** 2)
    w = w / w.sum(-1, keepdim=True)
    wk = w[:, :, None, None, None]                          # (B, 5, 1, 1, 1)
    pad = F.pad(x.permute(0, 3, 1, 2), (0, 0, 2, 2), mode='replicate') \
        .permute(0, 2, 3, 1)
    v = sum(wk[:, i] * pad[:, i:i + H] for i in range(5))
    pad = F.pad(v.permute(0, 3, 1, 2), (2, 2, 0, 0), mode='replicate') \
        .permute(0, 2, 3, 1)
    return sum(wk[:, i] * pad[:, :, i:i + W] for i in range(5))


def motion_blur(x: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """5-tap line blur along one of 4 directions per sample."""
    B, H, W, C = x.shape
    pad = F.pad(x.permute(0, 3, 1, 2), (2, 2, 2, 2), mode='replicate') \
        .permute(0, 2, 3, 1)
    outs = []
    for dy, dx in MOTION_DIRS:
        acc = sum(pad[:, 2 + dy * o:2 + dy * o + H, 2 + dx * o:2 + dx * o + W]
                  for o in (-2, -1, 0, 1, 2)) / 5.0
        outs.append(acc)
    return torch.stack(outs)[direction, torch.arange(B, device=x.device)]


def coarse_dropout(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Zero the cells of a coarse (gh, gw) grid where keep is False."""
    H, W = x.shape[1:3]
    gh, gw = keep.shape[1:3]
    k = keep.to(x.dtype)
    k = torch.repeat_interleave(k, -(-H // gh), 1)[:, :H]
    k = torch.repeat_interleave(k, -(-W // gw), 2)[:, :, :W]
    return x * k


def apply_color_aug(x: torch.Tensor, d: dict) -> torch.Tensor:
    """The pipeline of lc_tpu's color_augment on the drawn values `d`."""
    if 'sp_gate' in d:
        sp = torch.where(d['sp_salt'], 255.0, 0.0)
        x = torch.where(d['sp_gate'], torch.where(d['sp_hit'], sp, x), x)
    if 'mb_gate' in d:
        x = torch.where(d['mb_gate'], motion_blur(x, d['mb_dir']), x)
    x = torch.where(d['drop_gate'], coarse_dropout(x, d['drop_keep']), x)
    x = torch.where(d['blur_gate'], gaussian_blur(x, d['blur_sigma']), x)
    x = torch.where(d['add_gate'], x + d['add'], x)
    if 'inv_gate' in d:
        x = torch.where(d['inv_gate'] & d['inv_ch'], 255.0 - x, x)
    x = torch.where(d['mul_gate'], x * d['mul'], x)
    x = torch.where(d['mul2_gate'], x * d['mul2'], x)
    x = torch.where(d['contrast_gate'], 127.0 + d['alpha'] * (x - 127.0), x)
    return torch.clamp(x, 0.0, 255.0)


def color_augment(x: torch.Tensor, gen: torch.Generator, *,
                  use_pepper_salt=False, use_motion_blur=False,
                  use_invert=False) -> torch.Tensor:
    """Draw and apply. x: (B, H, W, 3) float in [0, 255]; inside a
    data-parallel context (parallel/mesh.py) the rows of this rank of a
    global batch of B · ranks crops: the values are drawn for the global
    batch and this rank's slice kept."""
    shard = mesh.active()
    count = 1 if shard is None else shard.count
    d = draw_color_aug((x.shape[0] * count,) + tuple(x.shape[1:]), gen,
                       use_pepper_salt=use_pepper_salt,
                       use_motion_blur=use_motion_blur, use_invert=use_invert,
                       device=x.device)
    if count > 1:
        d = {k: mesh.local_rows(v, shard) for k, v in d.items()}
    return apply_color_aug(x, d)


def switch_background(rgb: torch.Tensor, fg_mask: torch.Tensor,
                      bg: torch.Tensor, enable: torch.Tensor) -> torch.Tensor:
    """Composite crops over new backgrounds where enable[b]. rgb, bg:
    (B, h, w, 3); fg_mask: (B, h, w); enable: (B,)."""
    m = fg_mask[..., None]
    composed = rgb * m + bg * (1.0 - m)
    return torch.where(enable[:, None, None, None], composed, rgb)
