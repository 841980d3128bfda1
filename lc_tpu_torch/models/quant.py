"""Post-training int8 inference for the CNN (counterpart of
lc_tpu/models/quant.py).

Inside `quantized_int8(model)` every quantizable convolution of the model
(layers.Conv2d, layers.Deconv2x) computes

    w_q = round(w / s_w)     per-output-channel symmetric int8 weights
    x_q = round(x / s_x)     per-sample dynamic (or static per-conv) int8
    acc = conv(x_q, w_q)     int32 accumulation
    out = acc * (s_x * s_w) + bias, cast to the layer's compute dtype

with scale = max|x| / 127 floored at 1e-12, round half to even, clip ±127.
The f32 weights stay the single source of truth. Which convolutions run in
int8 follows lc_tpu: every plain convolution and the decoder
deconvolutions, but not the stem at even input sizes (lc_tpu computes it
there in its space-to-depth form, which is not an nn.Conv), and not the
dense weight-scale head (a Linear). At odd input sizes the stem is
quantized, as lc_tpu's plain strided stem is.

The int8 x int8 -> int32 product (`int8_conv_accumulate`) is an im2col
(a strided view of the padded int8 input, copied once) times the weights
through torch._int_mm on a CUDA tensor, its K and N padded with zeros to
multiples of 8 and M to more than 16, in chunks of samples that bound the
im2col's memory. On a CPU tensor the plain version computes the same
accumulators exactly, as a float64 convolution of the int8 values
(|acc| <= 127² · K < 2⁵³ for every K here).

Static scales (`calibrate_act_scales`) are measured with int8 already in
the loop and keyed by the module's name in model.named_modules().
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F

from . import layers
from .layers import Conv2d, Deconv2x

# `quantized_int8(act_scales=STATIC_SCALE_ANY)`: every convolution uses one
# fixed nominal scale. For timing only: the outputs are meaningless.
STATIC_SCALE_ANY = object()
_NOMINAL_SCALE = 0.05
# the largest im2col a chunk of samples may hold, in bytes
IM2COL_CHUNK_BYTES = 1 << 28


def quantize_tensor(x: torch.Tensor, dim=None, keepdim: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization: (q int8, scale f32), scale = max|x|/127
    over `dim` (all of x when None), floored at 1e-12 / 127. Without
    keepdim, `dim` must be the trailing dimensions (a per-output-channel
    scale of a weight)."""
    xf = x.float()
    amax = xf.abs().amax() if dim is None else xf.abs().amax(dim, True)
    scale = amax.clamp(min=1e-12) / 127.0
    q = _quantize(xf, scale)
    if dim is not None and not keepdim:
        scale = scale.reshape(scale.shape[:min(dim)])
    return q, scale


def _quantize(xf: torch.Tensor, scale) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def _quantize_act(x: torch.Tensor, scale):
    """Per-sample dynamic scales (NCHW: over C, H, W) when scale is None,
    else the fixed scalar."""
    if scale is None:
        return quantize_tensor(x, dim=(1, 2, 3), keepdim=True)
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return _quantize(x.float(), s), s


def _im2col(xq: torch.Tensor, k: tuple, stride: tuple, padding: tuple,
            dilation: tuple) -> torch.Tensor:
    """(B, C, H, W) int8 -> (B·Ho·Wo, C·kh·kw) rows in the weight's order."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = k, stride, padding, dilation
    xp = F.pad(xq, (pw, pw, ph, ph))
    win = xp.unfold(2, (kh - 1) * dh + 1, sh).unfold(3, (kw - 1) * dw + 1, sw)
    win = win[..., ::dh, ::dw]                        # (B, C, Ho, Wo, kh, kw)
    B, C, Ho, Wo = win.shape[:4]
    return win.permute(0, 2, 3, 1, 4, 5).reshape(B * Ho * Wo, C * kh * kw)


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))


def _int_mm_conv(xq, wq, stride, padding, dilation) -> torch.Tensor:
    O, _, kh, kw = wq.shape
    K = wq[0].numel()
    Kp, Np = -(-K // 8) * 8, -(-O // 8) * 8
    w2 = _pad_to(wq.reshape(O, K), Np, Kp)
    B, _, H, W = xq.shape
    Ho = (H + 2 * padding[0] - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    Wo = (W + 2 * padding[1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    out = torch.empty(B, O, Ho, Wo, dtype=torch.int32, device=xq.device)
    per = max(1, IM2COL_CHUNK_BYTES // (Ho * Wo * Kp))
    for b0 in range(0, B, per):
        cols = _im2col(xq[b0:b0 + per], (kh, kw), stride, padding, dilation)
        m = cols.shape[0]
        acc = torch._int_mm(_pad_to(cols, max(m, 17), Kp), w2.t())
        nb = min(per, B - b0)
        out[b0:b0 + nb] = acc[:m, :O].view(nb, Ho, Wo, O).permute(0, 3, 1, 2)
    return out


def int8_conv_accumulate(xq: torch.Tensor, wq: torch.Tensor, stride=(1, 1),
                         padding=(0, 0), dilation=(1, 1)) -> torch.Tensor:
    """int32 accumulators of the convolution of int8 xq (B, C, H, W) with
    int8 wq (O, C, kh, kw), zero padding: torch._int_mm over an im2col on
    a CUDA tensor, the exact float64 convolution on a CPU tensor."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError('int8_conv_accumulate takes int8 tensors')
    if xq.is_cuda:
        return _int_mm_conv(xq, wq, tuple(stride), tuple(padding),
                            tuple(dilation))
    if xq.device.type != 'cpu':
        raise RuntimeError(f'no int8 product for {xq.device}')
    return int8_conv_reference(xq, wq, stride, padding, dilation)


def int8_conv_reference(xq: torch.Tensor, wq: torch.Tensor, stride=(1, 1),
                        padding=(0, 0), dilation=(1, 1)) -> torch.Tensor:
    """The plain version of int8_conv_accumulate, on any device: the
    float64 convolution of the int8 values, exact at these sizes."""
    acc = F.conv2d(xq.double(), wq.double(), None, tuple(stride),
                   tuple(padding), tuple(dilation))
    return acc.to(torch.int32)


def deconv_input(xq: torch.Tensor) -> torch.Tensor:
    """The deconvolution as a convolution: zeros between the input's rows
    and columns (input dilation 2), padded (1, 2) on both axes."""
    B, C, H, W = xq.shape
    xd = xq.new_zeros(B, C, 2 * H + 2, 2 * W + 2)
    xd[:, :, 1:2 * H:2, 1:2 * W:2] = xq
    return xd


def int8_conv(m: Conv2d, x: torch.Tensor, act_scale=None) -> torch.Tensor:
    """The int8 form of m(x) (NCHW, zero padding, no groups)."""
    wq, ws = quantize_tensor(m.weight, dim=(1, 2, 3))        # ws (O,)
    xq, xs = _quantize_act(x, act_scale)
    acc = int8_conv_accumulate(xq, wq, m.stride, m.padding, m.dilation)
    out = acc.float() * (xs * ws[:, None, None])
    if m.bias is not None:
        out = out + m.bias[:, None, None]
    return out.to(m.compute_dtype)


def int8_deconv(m: Deconv2x, x: torch.Tensor, act_scale=None
                ) -> torch.Tensor:
    """The int8 form of the decoder's 2x deconvolution: the flipped kernel
    over the input dilated by 2, padding (1, 2)."""
    w = m.weight.transpose(0, 1).flip(2, 3)                  # (O, I, 3, 3)
    wq, ws = quantize_tensor(w, dim=(1, 2, 3))
    xq, xs = _quantize_act(x, act_scale)
    acc = int8_conv_accumulate(deconv_input(xq), wq)
    return (acc.float() * (xs * ws[:, None, None])).to(m.compute_dtype)


def quantizable(m, x: torch.Tensor) -> bool:
    """The convolutions int8 reproduces: a plain Conv2d (no groups, zero
    padding) or a Deconv2x; a stem only at odd input sizes."""
    if isinstance(m, Deconv2x):
        return True
    if type(m) is layers.StemConv2d:
        return x.shape[2] % 2 == 1 or x.shape[3] % 2 == 1
    return (type(m) is Conv2d and m.groups == 1
            and m.padding_mode == 'zeros')


class _Int8Mode:
    """What the convolutions read inside quantized_int8: the skip
    predicate, the static scales (None: dynamic) and, while calibrating,
    the record of each convolution's max|input|."""

    def __init__(self, model, skip, act_scales, record=None):
        self.skip = skip
        self.act_scales = act_scales
        self.record = record
        self.names = {id(m): n for n, m in model.named_modules()} \
            if model is not None else {}

    def takes(self, m, x) -> bool:
        return (self.skip is None or not self.skip(m)) and quantizable(m, x)

    def scale_for(self, m):
        if self.act_scales is None:
            return None
        if self.act_scales is STATIC_SCALE_ANY:
            return _NOMINAL_SCALE
        return self.act_scales.get(self.names.get(id(m)))

    def __call__(self, m, x):
        if self.record is not None:
            name = self.names[id(m)]
            amax = x.float().abs().amax()
            prev = self.record.get(name)
            self.record[name] = amax if prev is None \
                else torch.maximum(prev, amax)
            scale = None
        else:
            scale = self.scale_for(m)
        if isinstance(m, Deconv2x):
            return int8_deconv(m, x, scale)
        return int8_conv(m, x, scale)


@contextlib.contextmanager
def quantized_int8(model=None, skip: Callable | None = None,
                   act_scales=None):
    """Run the model's forward in this context with int8 convolutions.

    skip: a predicate on the module; True keeps that convolution in its
    compute dtype. act_scales: None for dynamic per-sample scales; the dict
    of calibrate_act_scales (by module name in `model`; a name missing
    from it quantizes dynamically); STATIC_SCALE_ANY for timing only."""
    if act_scales not in (None, STATIC_SCALE_ANY) and model is None:
        raise ValueError('static scales are keyed by module name: pass the '
                         'model')
    token = layers.INT8_MODE.set(_Int8Mode(model, skip, act_scales))
    try:
        yield
    finally:
        layers.INT8_MODE.reset(token)


@torch.no_grad()
def calibrate_act_scales(model, batches, skip: Callable | None = None
                         ) -> dict[str, torch.Tensor]:
    """Static per-convolution activation scales for quantized_int8: the
    forward runs on each batch with dynamic int8 in the loop (so deeper
    convolutions see the activations the quantized network produces), each
    quantizable convolution recording max|input|. Returns {module name:
    max(amax, 1e-12) / 127} over the batches."""
    record: dict[str, torch.Tensor] = {}
    token = layers.INT8_MODE.set(_Int8Mode(model, skip, None, record))
    try:
        for b in batches:
            model(b)
    finally:
        layers.INT8_MODE.reset(token)
    return {k: v.clamp(min=1e-12) / 127.0 for k, v in record.items()}
