"""EMA-adaptive clipping of activation gradients (counterpart of
lc_tpu/loss/clip.py; reference lib/utils/grad.py:5-31).

`grad_tap(x, max_norm, tap)` is the identity on x. Its backward clips the
cotangent to max_norm (global L2 over x) and hands the observed, unclipped
norm back as the gradient of the 0-d `tap` tensor. The train step reads
tap.grad after backward and folds it into the clipper's EMA threshold with
`update_clipper_state`, as lc_tpu does with its custom_vjp. Inside a
data-parallel context (parallel/mesh.py) the norm is that of the global
batch's cotangent, every rank's rows, as in lc_tpu's SPMD step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..parallel import mesh


class _GradTap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, max_norm, tap):
        ctx.save_for_backward(max_norm)
        ctx.shard = mesh.active()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (max_norm,) = ctx.saved_tensors
        total = torch.linalg.vector_norm(g.reshape(-1))
        if ctx.shard is not None:
            # the root of the rank-summed squares; the cotangent is at the
            # global loss's scale (each rank backpropagates its share)
            sq = total.square().reshape(1)
            dist.all_reduce(sq, group=ctx.shard.group)
            total = sq.sqrt()
        coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
        return g * coef, None, total.reshape(())


def grad_tap(x: torch.Tensor, max_norm: torch.Tensor,
             tap: torch.Tensor) -> torch.Tensor:
    """Identity on x; backward clips the cotangent to max_norm and reports
    its unclipped norm as the gradient of `tap` (0-d, requires_grad)."""
    return _GradTap.apply(x, max_norm, tap)


class ClipperState(NamedTuple):
    max_norm: torch.Tensor   # 0-d; < 0 means not initialized yet
    started: torch.Tensor    # 0-d bool


def init_clipper_state(device=None) -> ClipperState:
    return ClipperState(max_norm=torch.tensor(-1.0, device=device),
                        started=torch.tensor(False, device=device))


def clip_threshold(state: ClipperState,
                   initial_max_norm: float = 100.0) -> torch.Tensor:
    """The threshold to clip with this step (the static initial norm until
    the first update)."""
    return torch.where(state.max_norm > 0, state.max_norm,
                       torch.full_like(state.max_norm, initial_max_norm))


def update_clipper_state(state: ClipperState, observed_norm: torch.Tensor, *,
                         rel_thresh: float = 0.7, momentum: float = 0.1,
                         initial_max_norm: float = 100.0) -> ClipperState:
    """EMA update of the reference's NormClipper.clip (grad.py:19-30)."""
    scale = 1.0 + rel_thresh
    first = ~state.started & (state.max_norm <= 0)
    cur = clip_threshold(state, initial_max_norm)
    ema = cur * (1.0 - momentum) + momentum * scale * torch.minimum(
        observed_norm, cur * scale)
    return ClipperState(max_norm=torch.where(first, observed_norm * scale, ema),
                        started=torch.ones_like(state.started))
