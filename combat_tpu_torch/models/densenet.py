"""DenseNet (NCHW; the port of ``combat_tpu/models/densenet.py``).

Reference ``classifier_models/densenet.py`` (pytorch-cifar): a 3x3 stem to
2 x growth channels, dense stages of bottlenecks (BN-ReLU-1x1 conv to
4 x growth, BN-ReLU-3x3 conv to growth), transitions (BN-ReLU-1x1 conv,
average pool of 2) between them, then BN-ReLU, an average pool of 4 and a
linear head.  A bottleneck concatenates ``[out, x]``: its new features
first, the reverse of torchvision's DenseNet.  DenseNet121 is the
reference's alternative detector backbone.  Above 32 px the head reads a
pooled map larger than 1x1, flattened in PyTorch's (C, H, W) order
(``checkpoint/convert.py`` permutes the kernel).  Module names follow the
JAX model: its ``dense1_0`` is the port's ``dense1.0``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, Conv2d, Linear, avg_pool


class DenseBottleneck(nn.Module):
    def __init__(self, in_planes: int, growth_rate: int):
        super().__init__()
        self.bn1 = BatchNorm2d(in_planes)
        self.conv1 = Conv2d(in_planes, 4 * growth_rate, 1, bias=False)
        self.bn2 = BatchNorm2d(4 * growth_rate)
        self.conv2 = Conv2d(4 * growth_rate, growth_rate, 3, 1, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(F.relu(self.bn1(x)))
        out = self.conv2(F.relu(self.bn2(out)))
        return torch.cat([out, x], 1)


class Transition(nn.Module):
    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.bn = BatchNorm2d(in_planes)
        self.conv = Conv2d(in_planes, out_planes, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool(self.conv(F.relu(self.bn(x))), 2)


class DenseNet(nn.Module):
    def __init__(
        self,
        nblocks: Sequence[int],
        growth_rate: int = 12,
        reduction: float = 0.5,
        num_classes: int = 10,
        input_size: int = 32,
        in_channels: int = 3,
    ):
        super().__init__()
        self.num_stages = len(nblocks)
        num_planes = 2 * growth_rate
        self.conv1 = Conv2d(in_channels, num_planes, 3, 1, 1, bias=False)
        side = input_size
        for stage, nblock in enumerate(nblocks, start=1):
            blocks = []
            for _ in range(nblock):
                blocks.append(DenseBottleneck(num_planes, growth_rate))
                num_planes += growth_rate
            setattr(self, f"dense{stage}", nn.Sequential(*blocks))
            if stage < len(nblocks):
                out_planes = int(math.floor(num_planes * reduction))
                setattr(self, f"trans{stage}", Transition(num_planes, out_planes))
                num_planes, side = out_planes, side // 2
        self.bn = BatchNorm2d(num_planes)
        side //= 4  # average pool of 4, no padding
        self.linear = Linear(num_planes * side * side, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(x)
        for stage in range(1, self.num_stages + 1):
            out = getattr(self, f"dense{stage}")(out)
            if stage < self.num_stages:
                out = getattr(self, f"trans{stage}")(out)
        out = avg_pool(F.relu(self.bn(out)), 4)
        return self.linear(out.flatten(1))


def densenet121(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> DenseNet:
    return DenseNet((6, 12, 24, 16), 32, num_classes=num_classes, input_size=input_size, in_channels=in_channels)


def densenet169(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> DenseNet:
    return DenseNet((6, 12, 32, 32), 32, num_classes=num_classes, input_size=input_size, in_channels=in_channels)


def densenet201(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> DenseNet:
    return DenseNet((6, 12, 48, 32), 32, num_classes=num_classes, input_size=input_size, in_channels=in_channels)


def densenet161(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> DenseNet:
    return DenseNet((6, 12, 36, 24), 48, num_classes=num_classes, input_size=input_size, in_channels=in_channels)


def densenet_cifar(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> DenseNet:
    return DenseNet((6, 12, 24, 16), 12, num_classes=num_classes, input_size=input_size, in_channels=in_channels)
