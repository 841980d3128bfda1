"""Shared NN building blocks (counterpart of lc_tpu/models/layers.py).

Mixed precision as in lc_tpu: convolutions compute in `compute_dtype` (bf16
on the card; parameters stay f32), every BatchNorm computes in f32. The CPU
runs the convolutions in f32. BN eps is 1e-5, torch's default. Inside
models/quant.py's quantized_int8 context (INT8_MODE set) the convolutions it
takes compute in int8 instead.
"""
from __future__ import annotations

import contextvars

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh


def default_compute_dtype(device) -> torch.dtype:
    """bf16 convolutions on the card, f32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == 'cuda' \
        else torch.float32


# the int8 mode of models/quant.py, None outside its context
INT8_MODE: contextvars.ContextVar = contextvars.ContextVar('int8_mode',
                                                           default=None)


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in `compute_dtype`."""
    compute_dtype = torch.float32

    def forward(self, x):
        mode = INT8_MODE.get()
        if mode is not None and mode.takes(self, x):
            return mode(self, x)
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class StemConv2d(Conv2d):
    """The encoders' 7x7/s2 stem. A Conv2d in every respect; int8 inference
    takes it only at odd input sizes (models/quant.py)."""


class Deconv2x(nn.ConvTranspose2d):
    """ConvTranspose2d(k=3, s=2, p=1, output_padding=1) without bias, computing
    in `compute_dtype`: the decoder's 2x upsampling deconvolution."""
    compute_dtype = torch.float32

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, stride=2, padding=1,
                         output_padding=1, bias=False)

    def forward(self, x):
        mode = INT8_MODE.get()
        if mode is not None and mode.takes(self, x):
            return mode(self, x)
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                                  stride=2, padding=1, output_padding=1)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or in f64 when it is f64 (a model run in f64 as a rounding
    reference keeps f64 throughout)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class _GlobalBatchNorm(torch.autograd.Function):
    """Batch normalization over the rows of every rank of `group`, in x's
    dtype, with the global batch's mean and biased variance; the running
    statistics (when given) move by `momentum` with its unbiased variance,
    as torch's do.

    Forward: this rank's count, mean and second statistic in a table with
    a row per rank, one all-reduce of the table, the ranks' rows combined
    exactly (Chan et al.), then one normalizing pass. Backward, closed form:
    this rank's Σg and Σg·(x − mean) in one all-reduce, then one pass,
    dx = w/σ (g − Σg/n − x̂ Σg·x̂/n). The cotangent g is the global loss's
    (parallel/mesh.py's convention), so dx is too, and the weight's and
    bias's gradients are this rank's parts (Σg·x̂ and Σg over its rows),
    which the step's gradient all-reduce sums.

    On CUDA the passes are torch's fused batch-norm kernels, those of
    SyncBatchNorm (the second statistic 1/σ_r; batch_norm_stats,
    batch_norm_gather_stats_with_counts, batch_norm_elemt,
    batch_norm_backward_reduce, batch_norm_backward_elemt), which have no
    CPU kernels; elsewhere the same in plain operations (the second
    statistic M2_r, torch.var_mean's two-pass form: a one-pass
    E[x²] − E[x]² cancels in f32)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps, group, index, count):
        C = x.shape[1]
        rows = x.numel() // C
        if x.is_cuda:
            mean, stat = torch.batch_norm_stats(x, eps)
        else:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            stat = var * rows
        table = F.pad(torch.cat((mean.new_full((1,), rows), mean, stat))[None],
                      (0, 0, index, count - index - 1))
        dist.all_reduce(table, group=group)
        ns, means, stats = table[:, 0], table[:, 1:C + 1], table[:, C + 1:]
        if x.is_cuda:
            mean, invstd = torch.batch_norm_gather_stats_with_counts(
                x, means, stats, running_mean, running_var, momentum, eps, ns)
            y = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        else:
            n = ns.sum()
            mean = (ns[:, None] * means).sum(0) / n
            var = (stats + ns[:, None] * (means - mean) ** 2).sum(0) / n
            invstd = torch.rsqrt(var + eps)
            if running_mean is not None:
                running_mean.mul_(1 - momentum).add_(momentum * mean)
                running_var.mul_(1 - momentum).add_(
                    momentum * var * n / (n - 1))
            scale = invstd if weight is None else invstd * weight
            y = (x - mean[:, None, None]) * scale[:, None, None]
            if bias is not None:
                y = y + bias[:, None, None]
        ctx.save_for_backward(x, weight, mean, invstd, ns)
        ctx.group = group
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, invstd, ns = ctx.saved_tensors
        C = x.shape[1]
        g = g.contiguous()
        if x.is_cuda:
            sum_dy, sum_dy_xmu, dw, db = torch.batch_norm_backward_reduce(
                g, x, mean, invstd, weight, True, weight is not None,
                ctx.needs_input_grad[2])
            sums = torch.cat((sum_dy, sum_dy_xmu))
            dist.all_reduce(sums, group=ctx.group)
            dx = torch.batch_norm_backward_elemt(
                g, x, mean, invstd, weight, sums[:C], sums[C:],
                ns.to(torch.int32))
        else:
            xhat = (x - mean[:, None, None]) * invstd[:, None, None]
            local = torch.cat((g.sum((0, 2, 3)), (g * xhat).sum((0, 2, 3))))
            sums = local.clone()
            dist.all_reduce(sums, group=ctx.group)
            n = ns.sum()
            scale = invstd if weight is None else invstd * weight
            dx = (g - (sums[:C] / n)[:, None, None]
                  - xhat * (sums[C:] / n)[:, None, None]) \
                * scale[:, None, None]
            dw = None if weight is None else local[C:]
            db = local[:C] if ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None, None, None, None, None, None


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that computes in f32 whatever the convolutions' dtype.

    In training inside a data-parallel context (parallel/mesh.py) its
    statistics are those of the global batch, every rank's rows, as in
    lc_tpu's SPMD step (_GlobalBatchNorm); alone it is nn.BatchNorm2d's
    own call."""

    def forward(self, x):
        x = at_least_f32(x)
        shard = mesh.active()
        if self.training and shard is not None:
            return self._global_batch_norm(x, shard)
        return super().forward(x)

    def _global_batch_norm(self, x, shard):
        """Normalizes with the global batch's biased variance and moves the
        running statistics as nn.BatchNorm2d does."""
        running = self.track_running_stats
        f = 0.0
        if running:
            self.num_batches_tracked.add_(1)
            f = 1.0 / float(self.num_batches_tracked) \
                if self.momentum is None else self.momentum
        return _GlobalBatchNorm.apply(
            x, self.weight, self.bias, self.running_mean if running else None,
            self.running_var if running else None, f, self.eps, shard.group,
            shard.index, shard.count)


def upsample2x():
    """Bilinear 2x upsampling with align_corners=True (torch's
    UpsamplingBilinear2d, the reference decoder's upsample)."""
    return nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set the convolution compute dtype of every conv in `module`."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Deconv2x)):
            m.compute_dtype = dtype
    return module
