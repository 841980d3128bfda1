"""CDPN/GDR-Net dense-correspondence network (counterpart of
lc_tpu/models/cdpn.py): resnet34 encoder + a deconv/upsample decoder with a
64² output (128² with skip-concat).

The decoder keeps the reference's `features` Sequential indices, so reference
checkpoints load by name: without concat
  0 deconv, 1 bn, 2 relu, then conv/bn/relu pairs at 3-8, upsample 9,
  10-15, upsample 16, 17-22;
with concat, stage i occupies 3+7i .. 3+7i+6 as [upsample, conv, bn, relu,
conv, bn, relu], the skip feature concatenated before the upsample.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import BatchNorm2d, Conv2d, Deconv2x, upsample2x
from .resnet import ResNetBackbone

# resnet34 skip widths at 1/16, 1/8, 1/4 of the input (concat order)
_SKIP_CHANNELS = (256, 128, 64)


def _conv_bn_relu(cin: int, cout: int):
    return [Conv2d(cin, cout, 3, 1, 1, bias=False), BatchNorm2d(cout),
            nn.ReLU(inplace=True)]


class CDPNDecoder(nn.Module):
    def __init__(self, out_channels: int, num_layers: int = 3,
                 num_filters: int = 256, concat: bool = False,
                 output_kernel_size: int = 1, in_channels: int = 512):
        super().__init__()
        self.concat = concat
        self.num_layers = num_layers
        f = num_filters
        layers = [Deconv2x(in_channels, f), BatchNorm2d(f), nn.ReLU(inplace=True)]
        for i in range(num_layers):
            if concat:
                layers += [upsample2x()] + _conv_bn_relu(f + _SKIP_CHANNELS[i], f)
            elif i >= 1:
                layers += [upsample2x()] + _conv_bn_relu(f, f)
            else:
                layers += _conv_bn_relu(f, f)
            layers += _conv_bn_relu(f, f)
        self.features = nn.Sequential(*layers)
        k = output_kernel_size
        self.out_layer = Conv2d(f, out_channels, k, 1, k // 2, bias=True)

    def forward(self, x, skips):
        """x: 8²·512 encoder output; skips = (f64, f32, f16). NCHW."""
        if self.concat:
            f64, f32, f16 = skips
            x = self.features[:3](x)
            for i, skip in enumerate((f16, f32, f64)):
                x = torch.cat((x, skip), 1)
                x = self.features[3 + 7 * i:3 + 7 * (i + 1)](x)
        else:
            x = self.features(x)
        return self.out_layer(x), x


class ResNetCDPN(nn.Module):
    def __init__(self, out_channels: int, concat: bool = False):
        super().__init__()
        self.backbone = ResNetBackbone()
        self.decoder = CDPNDecoder(out_channels, concat=concat)

    def forward(self, rgb):
        high, f64, f32, f16 = self.backbone(rgb)
        return self.decoder(high, (f64, f32, f16))
