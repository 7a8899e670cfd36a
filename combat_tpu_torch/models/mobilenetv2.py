"""MobileNetV2, the CIFAR variant (NCHW; the port of
``combat_tpu/models/mobilenetv2.py``).

Reference ``classifier_models/mobilenetv2.py`` (pytorch-cifar): stride-1
stem, inverted residual blocks with the stride pattern 1, 1, 2, 2, 1, 2, 1,
a 1x1 conv to 1280 channels, an average pool of 4 and a linear head.  The
depthwise conv is a grouped conv (``groups`` = its planes).  A block adds a
shortcut only at stride 1: the identity where the width is kept, else a 1x1
conv and BatchNorm (``shortcut.0``, ``shortcut.1``; the JAX package's
``shortcut_conv``, ``shortcut_bn``).  Above 32 px the head reads a pooled
map larger than 1x1 (2x2 at 64 px, 7x7 at 224), flattened in PyTorch's
(C, H, W) order (``checkpoint/convert.py`` permutes the kernel).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, Conv2d, Linear, avg_pool

# (expansion, out_planes, num_blocks, stride) -- reference mobilenetv2.py:46-54
CFG = (
    (1, 16, 1, 1),
    (6, 24, 2, 1),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class InvertedResidual(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, expansion: int, stride: int):
        super().__init__()
        planes = expansion * in_planes
        self.stride = stride
        self.conv1 = Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, groups=planes, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, out_planes, 1, bias=False)
        self.bn3 = BatchNorm2d(out_planes)
        if stride == 1 and in_planes != out_planes:
            self.shortcut = nn.Sequential(Conv2d(in_planes, out_planes, 1, bias=False), BatchNorm2d(out_planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.stride == 1:
            out = out + (self.shortcut(x) if hasattr(self, "shortcut") else x)
        return out


class MobileNetV2(nn.Module):
    def __init__(self, num_classes: int = 10, input_size: int = 32, in_channels: int = 3):
        super().__init__()
        self.conv1 = Conv2d(in_channels, 32, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm2d(32)
        in_planes, side, i = 32, input_size, 0
        for expansion, out_planes, num_blocks, stride in CFG:
            for j in range(num_blocks):
                s = stride if j == 0 else 1
                setattr(self, f"block{i}", InvertedResidual(in_planes, out_planes, expansion, s))
                in_planes, side, i = out_planes, (side + 1) // 2 if s == 2 else side, i + 1
        self.num_blocks = i
        self.conv2 = Conv2d(in_planes, 1280, 1, bias=False)
        self.bn2 = BatchNorm2d(1280)
        side //= 4  # average pool of 4, no padding
        self.linear = Linear(1280 * side * side, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        for i in range(self.num_blocks):
            out = getattr(self, f"block{i}")(out)
        out = F.relu(self.bn2(self.conv2(out)))
        return self.linear(avg_pool(out, 4).flatten(1))


def mobilenetv2(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> MobileNetV2:
    return MobileNetV2(num_classes, input_size, in_channels)
