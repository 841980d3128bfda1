"""One training step on one device (counterpart of
lc_tpu/parallel/train_step.py, without the mesh).

The model's forward in train mode (bf16 convolutions on the card, as in
inference), the on-the-fly targets, every loss including the LC covariance
loss with the gradient taps, backward, the optimizer and scheduler steps,
and the clip thresholds updated from the taps' gradients. Eager: each call
is one step; the loss state (the binary-code histogram and the clip
thresholds) goes in and comes back. Its stages are torch.profiler ranges (forward, targets_losses,
backward, optimizer; train.step_inputs adds h2d and preprocess), from which
chip_smoke.py reads the step's breakdown. Data parallelism across cards is queued (ROADMAP A12).
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from .loss.loss_fn import (LossConfig, LossState, compute_losses,
                           finalize_loss_state, make_taps)
from .loss.targets import annots_on_the_fly


def forward_losses(model, loss_cfg: LossConfig, loss_state: LossState,
                   gt: dict, step: int, top_left, taps: dict, *,
                   sym_aware_start: int = 0):
    """The forward half of a step: (total, loss_dict, the loss state with
    this step's histogram; its clip thresholds move after backward)."""
    with record_function('forward'):
        out = model(gt['img_in'])
    with record_function('targets_losses'):
        gt = dict(gt, **annots_on_the_fly(
            gt, out, step=step, sym_aware_start=sym_aware_start,
            bit_cnt=loss_cfg.bit_cnt,
            black_background=loss_cfg.black_background))
        return compute_losses(loss_cfg, gt, out, loss_state, step, taps,
                              sample_top_left=top_left)


def global_grad_norm(params) -> torch.Tensor:
    grads = [p.grad.detach() for p in params if p.grad is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def train_step(model, optimizer, scheduler, loss_cfg: LossConfig,
               loss_state: LossState, gt: dict, step: int, top_left, *,
               sym_aware_start: int = 0):
    """Returns (new loss_state, metrics): metrics are 0-d tensors on the
    device (reading them syncs), the loss terms, `loss` and `grad_norm`.
    `step` counts from 0; `top_left` is the dense loss's sampling offset."""
    model.train()
    device = gt['img_in'].device
    taps = make_taps(device)
    optimizer.zero_grad(set_to_none=True)
    total, loss_dict, loss_state = forward_losses(
        model, loss_cfg, loss_state, gt, step, top_left, taps,
        sym_aware_start=sym_aware_start)
    with record_function('backward'):
        total.backward()
    with record_function('optimizer'):
        params = [p for g in optimizer.param_groups for p in g['params']]
        grad_norm = global_grad_norm(params)
        optimizer.step()
        scheduler.step()
        tap_grads = {k: t.grad if t.grad is not None
                     else torch.zeros((), device=device) for k, t in taps.items()}
        new_state = finalize_loss_state(loss_state, tap_grads, loss_cfg)
    metrics = {k: v.detach() for k, v in loss_dict.items()}
    metrics['loss'] = total.detach()
    metrics['grad_norm'] = grad_norm
    return new_state, metrics
