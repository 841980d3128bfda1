"""Optimizer and learning-rate schedule from the config (counterpart of
lc_tpu/optim/factory.py; reference utils.py:45-77)."""
from __future__ import annotations

import functools

import torch

from .ranger import Ranger
from .schedule import flat_and_anneal


def build_schedule(cfg_sched: dict, total_iters: int):
    """The learning-rate factor as a function of the step."""
    name = cfg_sched.get('name', 'none').lower()
    if name == 'flat_and_anneal':
        return functools.partial(
            flat_and_anneal, total_iters=total_iters,
            warmup_factor=cfg_sched.get('warmup_factor', 0.1),
            warmup_iters=cfg_sched.get('warmup_iters', 0),
            warmup_method=cfg_sched.get('warmup_method', 'linear'),
            anneal_method=cfg_sched.get('anneal_method', 'cosine'),
            anneal_point=cfg_sched.get('anneal_point', 0.72),
            steps=tuple(cfg_sched.get('rel_steps', (2 / 3.0, 8 / 9.0))),
            target_lr_factor=cfg_sched.get('target_lr_factor', 0.0),
            poly_power=cfg_sched.get('poly_power', 1.0),
            step_gamma=cfg_sched.get('step_gamma', 0.1))
    if name == 'none':
        return lambda step: 1.0
    raise ValueError(f'unknown scheduler {name}')


def build_optimizer(params, cfg_optim: dict, cfg_sched: dict,
                    total_iters: int):
    """(optimizer, lr scheduler): call scheduler.step() after every
    optimizer.step(). Adam's update i uses the factor at i, Ranger's at
    i + 1, as in lc_tpu (optax's adam counts from 0, its Ranger from 1)."""
    base_lr = cfg_optim['lr']
    wd = cfg_optim.get('wd', 0.0)
    factor = build_schedule(cfg_sched, total_iters)
    kind = cfg_optim['type'].lower()
    if kind == 'adam':
        # torch Adam couples the L2 term into the gradient, as the reference
        opt = torch.optim.Adam(params, lr=base_lr, eps=1e-8, weight_decay=wd)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
    if kind == 'ranger':
        opt = Ranger(params, lr=base_lr, weight_decay=wd)
        return opt, torch.optim.lr_scheduler.LambdaLR(
            opt, lambda step: factor(step + 1))
    raise ValueError(f'unknown optimizer {cfg_optim["type"]}')
