"""ResNet-34 encoders (counterpart of lc_tpu/models/resnet.py): CDPN's, with
torchvision's strides, and ZebraPose's output-stride-8 one, whose last two
stages are dilated.

Module names follow the reference checkpoints: torchvision's resnet for CDPN
(conv1, bn1, layer1..4, blocks with conv1/bn1/conv2/bn2/downsample.{0,1});
the reference zebra network's for ZebraResNetOS8 (see its docstring). The
stem is the plain 7x7/s2 convolution: lc_tpu's space-to-depth stem is a TPU
layout of the same arithmetic.
"""
from __future__ import annotations

from torch import nn

from .layers import BatchNorm2d, Conv2d, StemConv2d


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        d = dilation
        self.conv1 = Conv2d(inplanes, planes, 3, stride, d, dilation=d,
                            bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = Conv2d(planes, planes, 3, 1, d, dilation=d, bias=False)
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


def res_layer(inplanes: int, planes: int, n: int, stride: int = 1,
              dilation: int = 1) -> nn.Sequential:
    return nn.Sequential(
        BasicBlock(inplanes, planes, stride, dilation),
        *[BasicBlock(planes, planes, dilation=dilation) for _ in range(n - 1)])


class ResNetBackbone(nn.Module):
    """resnet34 encoder: 256² -> (8²·512, 64²·64, 32²·128, 16²·256), NCHW."""

    def __init__(self, layers=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = StemConv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            setattr(self, f'layer{i + 1}',
                    res_layer(inplanes, planes, n, 1 if i == 0 else 2))
            inplanes = planes

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        f64 = self.layer1(x)
        f32 = self.layer2(f64)
        f16 = self.layer3(f32)
        high = self.layer4(f16)
        return high, f64, f32, f16


class ZebraResNetOS8(nn.Module):
    """ZebraPose's resnet34 at output stride 8: 256² -> (32²·512 high,
    128²·64, 64²·64, 32²·128, 32²·256), NCHW. Stem and layer1..2 as
    resnet34; then a stage of 6 blocks with dilation 2 and one of 3 with
    dilation 4, both at stride 1.

    Names as the reference zebra checkpoint lays them out:
    resnet_layer_1 = (conv1, bn1, relu), resnet_layer_2 = (maxpool, layer1),
    resnet_layer_3 = (layer2,), then layer4 and layer5 (the dilated
    stages); x_16 keeps the reference's name, at 1/8 of the input."""

    def __init__(self):
        super().__init__()
        self.resnet_layer_1 = nn.Sequential(
            StemConv2d(3, 64, 7, 2, 3, bias=False), BatchNorm2d(64),
            nn.ReLU(inplace=True))
        self.resnet_layer_2 = nn.Sequential(nn.MaxPool2d(3, 2, 1),
                                            res_layer(64, 64, 3))
        self.resnet_layer_3 = nn.Sequential(res_layer(64, 128, 4, 2))
        self.layer4 = res_layer(128, 256, 6, dilation=2)
        self.layer5 = res_layer(256, 512, 3, dilation=4)

    def forward(self, x):
        x_128 = self.resnet_layer_1(x)
        x_64 = self.resnet_layer_2(x_128)
        x_32 = self.resnet_layer_3(x_64)
        x_16 = self.layer4(x_32)
        high = self.layer5(x_16)
        return high, x_128, x_64, x_32, x_16
