"""Ranger: RAdam + lookahead + gradient centralization, as one
torch.optim.Optimizer (counterpart of lc_tpu/optim/ranger.py; reference
lib/optim/ranger.py:29-200).

  * gradient centralization on tensors with more than one dimension, over
    every axis but the first: in torch's (out, in, kh, kw) and (out, in)
    layouts that is per output channel, as in the reference;
  * RAdam with betas (0.95, 0.999), eps 1e-5 and the N_sma threshold 5
    (momentum SGD while the variance estimate is not rectifiable), with the
    threshold resolved once as an integer step and 1 − β^t through expm1;
  * decoupled weight decay p ← p − wd·lr·p;
  * lookahead: every k = 6 steps, p ← slow + α(p − slow), α = 0.5.
"""
from __future__ import annotations

import math

import torch


def first_rectified_step(b2: float, threshold: float) -> int:
    """The first step at which RAdam's N_sma exceeds the threshold, in f64.
    N_sma crosses it once; an f32 comparison near the crossing is off by
    ±0.03, enough to flip the step and change its update ~1000-fold."""
    n_max = 2.0 / (1.0 - b2) - 1.0
    for t in range(1, 10_000_000):
        b2t = b2 ** t
        if n_max - 2.0 * t * b2t / (1.0 - b2t) > threshold:
            return t
    raise ValueError(f'N_sma never exceeds {threshold} for b2={b2}')


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


class Ranger(torch.optim.Optimizer):
    def __init__(self, params, lr: float, *, alpha: float = 0.5, k: int = 6,
                 n_sma_threshold: float = 5.0, betas=(0.95, 0.999),
                 eps: float = 1e-5, weight_decay: float = 0.0):
        defaults = dict(lr=lr, alpha=alpha, k=k, betas=betas, eps=eps,
                        weight_decay=weight_decay,
                        rect_step=first_rectified_step(betas[1],
                                                       n_sma_threshold))
        super().__init__(params, defaults)

    @staticmethod
    def _scalars(step: int, b1: float, b2: float, rect_step: int):
        """(step size, rectified) of RAdam at `step`, in f32 as lc_tpu."""
        stepf = torch.tensor(float(step), dtype=torch.float32)
        one_minus_b2t = -torch.expm1(stepf * math.log(b2))
        bias1 = -torch.expm1(stepf * math.log(b1))
        if step < rect_step:
            return float(1.0 / bias1), False
        beta2_t = 1.0 - one_minus_b2t
        n_max = 2.0 / (1.0 - b2) - 1.0
        n_sma = n_max - 2.0 * stepf * beta2_t / one_minus_b2t
        rect = torch.sqrt(one_minus_b2t * (n_sma - 4.0) / (n_max - 4.0)
                          * (n_sma - 2.0) / n_sma * n_max / (n_max - 2.0))
        return float(rect / bias1), True

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter that has a gradient. The update is
        written with torch._foreach ops, a few launches for all tensors of a
        group; only the gradient centralization runs per tensor."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            ps = [p for p in group['params'] if p.grad is not None]
            if not ps:
                continue
            b1, b2 = group['betas']
            lr = _f32(group['lr'])
            for p in ps:
                if not self.state[p]:
                    self.state[p].update(step=0, exp_avg=torch.zeros_like(p),
                                         exp_avg_sq=torch.zeros_like(p),
                                         slow=p.detach().clone())
            states = [self.state[p] for p in ps]
            steps = {st['step'] + 1 for st in states}
            if len(steps) != 1:
                raise RuntimeError('Ranger: the parameters of a group are at '
                                   'different steps')
            step = steps.pop()
            for st in states:
                st['step'] = step
            gs = [p.grad - p.grad.mean(dim=tuple(range(1, p.dim())),
                                       keepdim=True)
                  if p.dim() > 1 else p.grad
                  for p in ps]
            ms = [st['exp_avg'] for st in states]
            vs = [st['exp_avg_sq'] for st in states]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - b1))
            torch._foreach_mul_(vs, b2)
            torch._foreach_add_(vs, torch._foreach_mul(
                torch._foreach_mul(gs, gs), 1 - b2))
            step_size, rectified = self._scalars(step, b1, b2,
                                                 group['rect_step'])
            if rectified:
                denom = torch._foreach_sqrt(vs)
                torch._foreach_add_(denom, group['eps'])
                upd = torch._foreach_div(ms, denom)
            else:
                upd = ms
            d = torch._foreach_mul(upd, -_f32(step_size * lr))
            if group['weight_decay'] != 0.0:
                torch._foreach_sub_(d, torch._foreach_mul(
                    ps, _f32(group['weight_decay'] * lr)))
            if step % group['k'] == 0:        # lookahead: land on the slow
                slows = [st['slow'] for st in states]
                fast = torch._foreach_add(ps, d)
                torch._foreach_sub_(fast, slows)
                torch._foreach_add_(slows, torch._foreach_mul(
                    fast, group['alpha']))
                d = torch._foreach_sub(slows, ps)
            torch._foreach_add_(ps, d)
        return loss
