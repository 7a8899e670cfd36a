"""ResNet (NCHW; the port of ``combat_tpu/models/resnet.py``).

The pytorch-cifar ResNet of the reference's ``classifier_models/resnet.py``:
3x3 stem with no max-pool, four stages of BasicBlocks or Bottlenecks (64,
128, 256, 512 planes), average pool of 4, linear.  The default classifier
of celeba and imagenet10.  The linear layer is sized from the pooled map the
strides give, as the JAX model's ``dense`` infers it: 1x1 at 32 px, 2x2 at
64, 7x7 at 224 (where the reference's ``input_size2scaler`` has no entry).
State-dict names follow the reference (``layer1.0.bn1``, ``shortcut.0`` the
projection conv, ``shortcut.1`` its BatchNorm, ``linear``).

Defense hooks, as in the JAX package and the port's PreActResNet:
``channel_mask`` multiplies the layer4 output channels (fine-pruning);
``capture_features`` returns the per-stage activations and
``feature_perturb`` adds a tensor to a stage output (Grad-CAM).

In a ``--compute_dtype`` run (``layers.py``), as in the JAX package, a
block's residual sum is of BatchNorm outputs, so float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, Conv2d, Linear


def _shortcut(in_planes: int, out_planes: int, stride: int) -> Optional[nn.Sequential]:
    """The projection shortcut (1x1 conv, BatchNorm) where the block changes
    the stride or the width, else None (identity)."""
    if stride == 1 and in_planes == out_planes:
        return None
    return nn.Sequential(Conv2d(in_planes, out_planes, 1, stride, bias=False), BatchNorm2d(out_planes))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        shortcut = _shortcut(in_planes, planes, stride)
        if shortcut is not None:
            self.shortcut = shortcut

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + (self.shortcut(x) if hasattr(self, "shortcut") else x))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, self.expansion * planes, 1, bias=False)
        self.bn3 = BatchNorm2d(self.expansion * planes)
        shortcut = _shortcut(in_planes, self.expansion * planes, stride)
        if shortcut is not None:
            self.shortcut = shortcut

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (self.shortcut(x) if hasattr(self, "shortcut") else x))


class ResNet(nn.Module):
    def __init__(
        self,
        num_blocks: Sequence[int] = (2, 2, 2, 2),
        num_classes: int = 10,
        input_size: int = 32,
        in_channels: int = 3,
        bottleneck: bool = False,
    ):
        super().__init__()
        block = Bottleneck if bottleneck else BasicBlock
        self.conv1 = Conv2d(in_channels, 64, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm2d(64)
        in_planes = 64
        for stage, (planes, stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2)), start=1):
            blocks = []
            for i in range(num_blocks[stage - 1]):
                blocks.append(block(in_planes, planes, stride if i == 0 else 1))
                in_planes = planes * block.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))
        side = input_size
        for _ in range(3):  # layers 2-4 halve the map (3x3, stride 2, padding 1)
            side = (side + 1) // 2
        side //= 4  # average pool of 4, no padding
        self.linear = Linear(in_planes * side * side, num_classes)

    def forward(
        self,
        x: torch.Tensor,
        channel_mask: Optional[torch.Tensor] = None,
        capture_features: bool = False,
        feature_perturb: Optional[Dict[str, torch.Tensor]] = None,
    ):
        out = F.relu(self.bn1(self.conv1(x)))
        feats = {}
        for stage in range(1, 5):
            name = f"layer{stage}"
            out = getattr(self, name)(out)
            if feature_perturb is not None and name in feature_perturb:
                out = out + feature_perturb[name]
            feats[name] = out
        if channel_mask is not None:
            out = out * channel_mask.to(out.dtype)[None, :, None, None]
        out = F.avg_pool2d(out, 4).flatten(1)
        logits = self.linear(out)
        if capture_features:
            return logits, feats
        return logits


def resnet18(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> ResNet:
    return ResNet((2, 2, 2, 2), num_classes, input_size, in_channels)


def resnet34(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes, input_size, in_channels)


def resnet50(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes, input_size, in_channels, bottleneck=True)


def resnet101(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> ResNet:
    return ResNet((3, 4, 23, 3), num_classes, input_size, in_channels, bottleneck=True)


def resnet152(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> ResNet:
    return ResNet((3, 8, 36, 3), num_classes, input_size, in_channels, bottleneck=True)
