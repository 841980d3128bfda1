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
import torch.nn.functional as F
from torch import nn


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


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that computes in f32 whatever the convolutions' dtype."""

    def forward(self, x):
        return super().forward(at_least_f32(x))


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
