"""The flat-and-anneal learning-rate factor (counterpart of
lc_tpu/optim/schedule.py; reference lib/optim/lr_scheduler.py:179-265):
linear or constant warmup, a flat section, then cosine / linear / poly /
exp / step annealing from anneal_point · total_iters on. A plain function
of the step; multiply by the base learning rate."""
from __future__ import annotations

import math

ANNEAL_METHODS = ('cosine', 'linear', 'poly', 'exp', 'step', 'none')


def flat_and_anneal(step: float, *, total_iters: int, warmup_iters: int = 0,
                    warmup_factor: float = 0.1, warmup_method: str = 'linear',
                    anneal_point: float = 0.72, anneal_method: str = 'cosine',
                    target_lr_factor: float = 0.0, poly_power: float = 1.0,
                    step_gamma: float = 0.1,
                    steps=(2 / 3.0, 8 / 9.0)) -> float:
    """The learning-rate factor at `step`."""
    if warmup_method not in ('constant', 'linear'):
        raise ValueError(f'bad warmup_method {warmup_method}')
    if anneal_method not in ANNEAL_METHODS:
        raise ValueError(f'bad anneal_method {anneal_method}')
    x = float(step)
    if x < warmup_iters:
        if warmup_method == 'constant':
            return warmup_factor
        a = x / warmup_iters
        return warmup_factor * (1 - a) + a
    if anneal_method == 'step':
        anneal_start = steps[0] * total_iters
    else:
        if not 0 <= anneal_point <= 1:
            raise ValueError(f'anneal_point must be in [0,1], got {anneal_point}')
        anneal_start = anneal_point * total_iters
    if x < anneal_start:
        return 1.0
    prog = (x - anneal_start) / max(total_iters - anneal_start, 1e-8)
    if anneal_method == 'cosine':
        return target_lr_factor + 0.5 * (1 - target_lr_factor) * (
            1 + math.cos(math.pi * prog))
    if anneal_method == 'linear':
        return target_lr_factor + (1 - target_lr_factor) * (1 - prog)
    if anneal_method == 'poly':
        return target_lr_factor + (1 - target_lr_factor) * \
            max(1 - prog, 0.0) ** poly_power
    if anneal_method == 'exp':
        return max(target_lr_factor, 5e-3) ** prog
    if anneal_method == 'step':
        return step_gamma ** sum(x >= s * total_iters for s in steps)
    return 1.0
