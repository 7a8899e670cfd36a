"""PreActResNet (NCHW; the port of ``combat_tpu/models/preact_resnet.py``).

Architecture of the reference's ``classifier_models/preact_resnet.py``:
stem 3x3 conv, four stages of PreActBlocks (64, 128, 256, 512), average pool
of 4, linear.  The linear layer is sized from the pooled map the strides
give, as the JAX model's ``dense`` infers it: 1x1 at 32 and 28 px, 2x2 at
64.  State-dict names follow the reference (``layer1.0.bn1``,
``shortcut.0``, ``linear``).

Defense hooks, as in the JAX package:
  * ``channel_mask`` multiplies the layer4 output channels (fine-pruning);
  * ``capture_features`` returns the per-stage activations and
    ``feature_perturb`` adds a tensor to a stage output (Grad-CAM);
  * ``act`` replaces the ReLU (Guided Backprop passes ``guided_relu``).

In a ``--compute_dtype`` run (``layers.py``), as in the JAX package, a
block's residual sum stays in the convolutions' dtype.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, Conv2d, Linear


class PreActBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1, act: Callable = F.relu):
        super().__init__()
        self.act = act
        self.bn1 = BatchNorm2d(in_planes)
        self.conv1 = Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(Conv2d(in_planes, planes, 1, stride, bias=False))

    def forward(self, x):
        out = self.act(self.bn1(x))
        shortcut = self.shortcut(out) if hasattr(self, "shortcut") else x
        out = self.conv1(out)
        out = self.conv2(self.act(self.bn2(out)))
        return out + shortcut


class PreActResNet(nn.Module):
    def __init__(
        self,
        num_blocks: Sequence[int] = (2, 2, 2, 2),
        num_classes: int = 10,
        input_size: int = 32,
        in_channels: int = 3,
        act: Callable = F.relu,
    ):
        super().__init__()
        self.conv1 = Conv2d(in_channels, 64, 3, 1, 1, bias=False)
        in_planes = 64
        for stage, (planes, stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2)), start=1):
            blocks = []
            for i in range(num_blocks[stage - 1]):
                blocks.append(PreActBlock(in_planes, planes, stride if i == 0 else 1, act=act))
                in_planes = planes
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))
        side = input_size
        for _ in range(3):  # layers 2-4 halve the map (3x3, stride 2, padding 1)
            side = (side + 1) // 2
        side //= 4  # average pool of 4, no padding
        self.linear = Linear(512 * side * side, num_classes)

    def forward(
        self,
        x: torch.Tensor,
        channel_mask: Optional[torch.Tensor] = None,
        capture_features: bool = False,
        feature_perturb: Optional[Dict[str, torch.Tensor]] = None,
    ):
        out = self.conv1(x)
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


def preact_resnet18(num_classes: int = 10, input_size: int = 32, in_channels: int = 3, **kw) -> PreActResNet:
    return PreActResNet((2, 2, 2, 2), num_classes, input_size, in_channels, **kw)
