"""ResNet-34 encoder for CDPN (counterpart of lc_tpu/models/resnet.py).

Module names follow torchvision's resnet (conv1, bn1, layer1..4, blocks with
conv1/bn1/conv2/bn2/downsample.{0,1}), the layout the reference checkpoints
use. The stem is the plain 7x7/s2 convolution: lc_tpu's space-to-depth stem
is a TPU layout of the same arithmetic.
"""
from __future__ import annotations

from torch import nn

from .layers import BatchNorm2d, Conv2d


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes, 1, stride, bias=False),
                BatchNorm2d(planes))

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        sc = x if self.downsample is None else self.downsample(x)
        return self.relu(out + sc)


class ResNetBackbone(nn.Module):
    """resnet34 encoder: 256² -> (8²·512, 64²·64, 32²·128, 16²·256), NCHW."""

    def __init__(self, layers=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if i == 0 else 2
            blocks = [BasicBlock(inplanes, planes, stride)]
            blocks += [BasicBlock(planes, planes) for _ in range(n - 1)]
            setattr(self, f'layer{i + 1}', nn.Sequential(*blocks))
            inplanes = planes

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        f64 = self.layer1(x)
        f32 = self.layer2(f64)
        f16 = self.layer3(f32)
        high = self.layer4(f16)
        return high, f64, f32, f16
