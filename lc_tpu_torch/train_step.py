"""One training step (counterpart of lc_tpu/parallel/train_step.py).

The model's forward in train mode (bf16 convolutions on the card, as in
inference), the on-the-fly targets, every loss including the LC covariance
loss with the gradient taps, backward, the optimizer and scheduler steps,
and the clip thresholds updated from the taps' gradients. Eager: each call
is one step; the loss state (the binary-code histogram and the clip
thresholds) goes in and comes back. Its stages are torch.profiler ranges
(forward, targets_losses, backward, all_reduce, optimizer; the staging of
its input in data/pipeline.device_prefetch adds h2d and preprocess), from
which chip_smoke.py reads the step's breakdown.

Data-parallel (inside a data-parallel context, parallel/mesh.py):
BatchNorm, the losses' means, the histogram and the clip taps take the
global batch; each rank backpropagates its share of the
global loss (loss / count) and one flat all-reduce sums the gradients, the
global gradient, on every rank. An explicit all-reduce and not
DistributedDataParallel: DDP averages the gradients, which with the
cross-rank statistics' backward (a sum over ranks) would need the loss
scaled back, and it renames the model's state_dict keys. With no shard the
step is the single-process one, untouched.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from .loss.loss_fn import (LossConfig, LossState, compute_losses,
                           finalize_loss_state, make_taps)
from .loss.targets import annots_on_the_fly
from .parallel import mesh


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
    device (reading them syncs), the loss terms, `loss` and `grad_norm`,
    the global batch's on every rank of the active data-parallel group.
    `step` counts from 0; `top_left` is the dense loss's sampling offset;
    `gt` holds this rank's rows."""
    shard = mesh.active()
    model.train()
    device = gt['img_in'].device
    taps = make_taps(device)
    optimizer.zero_grad(set_to_none=True)
    params = [p for g in optimizer.param_groups for p in g['params']]
    total, loss_dict, loss_state = forward_losses(
        model, loss_cfg, loss_state, gt, step, top_left, taps,
        sym_aware_start=sym_aware_start)
    with record_function('backward'):
        (total if shard is None else total / shard.count).backward()
    if shard is not None:
        with record_function('all_reduce'):
            mesh.all_reduce_grads(params, shard)
    with record_function('optimizer'):
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
