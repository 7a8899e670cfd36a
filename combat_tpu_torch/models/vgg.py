"""VGG11/13/16/19 (NCHW; the port of ``combat_tpu/models/vgg.py``).

Reference ``classifier_models/vgg.py:7-45``: conv(3x3, bias)-BN-ReLU stacks
with 2x2 max pools; its trailing ``AvgPool2d(1)`` is an identity and is
dropped.  The head flattens the last map with no pool: 1x1 at 32 px, 2x2 at
64, 7x7 at 224, so ``checkpoint/convert.py`` permutes the JAX package's
(H, W, C)-ordered kernel to PyTorch's (C, H, W) order.  Module names follow
the JAX model (``conv{i}``, ``bn{i}``, ``classifier``).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, Conv2d, Linear

CFG = {
    "VGG11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "VGG13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "VGG16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"),
    "VGG19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGG(nn.Module):
    def __init__(
        self, cfg: Sequence[Union[int, str]], num_classes: int = 10, input_size: int = 32, in_channels: int = 3
    ):
        super().__init__()
        self.cfg = tuple(cfg)
        cin, side, i = in_channels, input_size, 0
        for item in self.cfg:
            if item == "M":
                side //= 2
                continue
            setattr(self, f"conv{i}", Conv2d(cin, item, 3, 1, 1))
            setattr(self, f"bn{i}", BatchNorm2d(item))
            cin, i = item, i + 1
        self.classifier = Linear(cin * side * side, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i = 0
        for item in self.cfg:
            if item == "M":
                x = F.max_pool2d(x, 2)
            else:
                x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
                i += 1
        return self.classifier(x.flatten(1))


def vgg(name: str, num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> VGG:
    return VGG(CFG[name], num_classes, input_size, in_channels)
