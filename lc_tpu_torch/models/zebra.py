"""ZebraPose DeepLabV3 dense-correspondence network (counterpart of
lc_tpu/models/zebra.py): resnet34 at output stride 8, ASPP (rates 6/12/18
and image pooling), then two 2x deconvolution stages with skip concats to a
128² output (for a 256² input). The feature is 256 + 64 = 320 wide.

Module names follow the reference checkpoint: net.aspp.{conv_1x1_1,
conv_3x3_1..3, conv_1x1_2 (image pooling), conv_1x1_3 (projection)}, each
with its bn_<name>; upsample_{1,2} as Sequentials [deconv, bn, relu, conv,
bn, relu, conv, bn, relu] (parameters at 0, 1, 3, 4, 6, 7); the output
convolution conv_1x1_4.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, Conv2d, Deconv2x
from .resnet import ZebraResNetOS8


def _upsample_stage(cin: int, f: int = 256) -> nn.Sequential:
    return nn.Sequential(
        Deconv2x(cin, f), BatchNorm2d(f), nn.ReLU(inplace=True),
        Conv2d(f, f, 3, 1, 1, bias=False), BatchNorm2d(f), nn.ReLU(inplace=True),
        Conv2d(f, f, 3, 1, 1, bias=False), BatchNorm2d(f), nn.ReLU(inplace=True))


class ASPP(nn.Module):
    # (name, kernel, dilation) of the branches over the 512-wide high feature
    BRANCHES = (('conv_1x1_1', 1, 1), ('conv_3x3_1', 3, 6),
                ('conv_3x3_2', 3, 12), ('conv_3x3_3', 3, 18),
                ('conv_1x1_2', 1, 1))

    def __init__(self, num_classes: int, output_kernel_size: int = 1,
                 in_channels: int = 512, f: int = 256, skip: int = 64):
        super().__init__()
        for name, k, d in self.BRANCHES:
            setattr(self, name, Conv2d(in_channels, f, k, 1, d * (k // 2),
                                       dilation=d, bias=True))
            setattr(self, f'bn_{name}', BatchNorm2d(f))
        self.conv_1x1_3 = Conv2d(5 * f, f, 1, bias=True)
        self.bn_conv_1x1_3 = BatchNorm2d(f)
        self.upsample_1 = _upsample_stage(f, f)
        self.upsample_2 = _upsample_stage(f + skip, f)
        k = output_kernel_size
        self.conv_1x1_4 = Conv2d(f + skip, num_classes, k, 1, k // 2, bias=True)

    def _branch(self, name, x):
        return F.relu(getattr(self, f'bn_{name}')(getattr(self, name)(x)))

    def forward(self, high, x_128, x_64):
        h, w = high.shape[2:]
        branches = [self._branch(n, high) for n, _, _ in self.BRANCHES[:4]]
        img = self._branch('conv_1x1_2', high.mean((2, 3), keepdim=True))
        branches.append(img.expand(-1, -1, h, w))
        x = self._branch('conv_1x1_3', torch.cat(branches, 1))
        x = self.upsample_1(x)                                   # 32² -> 64²
        x = self.upsample_2(torch.cat((x, x_64), 1))              # -> 128²
        feature = torch.cat((x, x_128), 1)                       # 256 + 64
        return self.conv_1x1_4(feature), feature


class ZebraDeepLabV3(nn.Module):
    feature_dim = 256 + 64

    def __init__(self, out_channels: int, output_kernel_size: int = 1):
        super().__init__()
        self.resnet = ZebraResNetOS8()
        self.aspp = ASPP(out_channels, output_kernel_size)

    def forward(self, rgb):
        high, x_128, x_64, _, _ = self.resnet(rgb)
        return self.aspp(high, x_128, x_64)
