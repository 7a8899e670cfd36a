"""The extended classifier zoo (NCHW; the port of ``combat_tpu/models/zoo_extra.py``).

The reference's pytorch-cifar models (``classifier_models/{lenet,mobilenet,
efficientnet,googlenet,dpn,senet,resnext,shufflenet,shufflenetv2,
pnasnet}.py``), with the JAX package's fixes: ``num_classes`` is an
argument, ShuffleNet's bottleneck width is an integer.  Every head is sized
from the pooled map the strides leave at ``input_size``; a head that reads a
map larger than 1x1 flattens it in PyTorch's (C, H, W) order
(``checkpoint/convert.py`` permutes the JAX package's (H, W, C)-ordered
kernel).  Where the average pool leaves no map at all (GoogLeNet, the
ResNeXts and the PNASNets at mnist's 28 px), Flax's ``init`` raises, and so
does the constructor here.  Module names follow the JAX model's
(``layer1_0``, ``b3_pw``, ``Conv_0``), so a state-dict key is the Flax path
joined by dots.

Precision (``layers.py``): the JAX package's ``_convb`` and ``dense`` take
``--compute_dtype`` and are :class:`~.layers.Conv2d` / :class:`~.layers.Linear`
here; its ``nn.Conv`` without ``dtype=`` (LeNet's convolutions, EfficientNet's
and SENet's squeeze-excitation, all of GoogLeNet's) is ``torch.nn.Conv2d``,
float32 in any run, its input promoted as Flax promotes it.

EfficientNetB0's dropout (p 0.2 after each block's projection) draws one
keep per (row, channel), a mask of shape (N, C, 1, 1); it is live in train
mode only.  Its masks can be passed in (``masks``, one a block;
:meth:`EfficientNetB0.mask_shapes`) or drawn from ``generator``.  The JAX
C-steps pass no dropout rng, so they stop on it as ``--model``
(``train/steps.py::refuse_train_dropout``); as ``--F_model`` the detector
step draws its masks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, Conv2d, Dropout, Linear, avg_pool


def _convb(cin: int, cout: int, kernel: int = 3, stride: int = 1, groups: int = 1) -> Conv2d:
    """The JAX package's ``_convb``: no bias, padding (kernel - 1) // 2, in the compute dtype."""
    return Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, groups=groups, bias=False)


def _down(side: int) -> int:
    """A stride-2 convolution or pool with padding (kernel - 1) // 2: ceil(side / 2)."""
    return (side + 1) // 2


def _head(channels: int, side: int, window: int, num_classes: int) -> Linear:
    """The linear on the flattened average pool of ``window`` (no padding) of
    a ``side`` x ``side`` map of ``channels``."""
    pooled = side // window
    if pooled == 0:
        raise ValueError(f"an average pool of {window} leaves nothing of a {side} x {side} map (Flax's init "
                         "raises ZeroDivisionError on the empty head)")
    return Linear(channels * pooled * pooled, num_classes)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    n, c, h, w = x.shape
    return x.view(n, groups, c // groups, h, w).transpose(1, 2).reshape(n, c, h, w)


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------- LeNet


class LeNet(nn.Module):
    """Reference ``lenet.py:7-25``: two 5x5 valid convolutions (float32,
    with bias), each followed by ReLU and a 2x2 max pool, then three linears."""

    def __init__(self, num_classes: int = 10, input_size: int = 32, in_channels: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, 6, 5)
        self.Conv_1 = nn.Conv2d(6, 16, 5)
        side = ((input_size - 4) // 2 - 4) // 2
        self.fc1 = Linear(16 * side * side, 120)
        self.fc2 = Linear(120, 84)
        self.fc3 = Linear(84, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2)
        x = F.relu(self.fc1(x.flatten(1)))
        return self.fc3(F.relu(self.fc2(x)))


# ---------------------------------------------------------------- MobileNet v1

MOBILENET_CFG = (64, (128, 2), 128, (256, 2), 256, (512, 2), 512, 512, 512, 512, 512, (1024, 2), 1024)


class MobileNetV1(nn.Module):
    """Reference ``mobilenet.py``: a 3x3 stem, then depthwise (``b{i}_dw``)
    and pointwise (``b{i}_pw``) convolutions, each with BatchNorm and ReLU,
    an average pool of 2 and a linear."""

    def __init__(self, num_classes: int = 10, input_size: int = 32, in_channels: int = 3,
                 cfg: Sequence = MOBILENET_CFG):
        super().__init__()
        self.conv1 = _convb(in_channels, 32)
        self.bn1 = BatchNorm2d(32)
        cin, side = 32, input_size
        self.num_blocks = len(cfg)
        for i, item in enumerate(cfg):
            planes, stride = (item, 1) if isinstance(item, int) else item
            setattr(self, f"b{i}_dw", _convb(cin, cin, 3, stride, groups=cin))
            setattr(self, f"b{i}_bn1", BatchNorm2d(cin))
            setattr(self, f"b{i}_pw", _convb(cin, planes, 1))
            setattr(self, f"b{i}_bn2", BatchNorm2d(planes))
            cin, side = planes, _down(side) if stride == 2 else side
        self.linear = _head(cin, side, 2, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        for i in range(self.num_blocks):
            out = F.relu(getattr(self, f"b{i}_bn1")(getattr(self, f"b{i}_dw")(out)))
            out = F.relu(getattr(self, f"b{i}_bn2")(getattr(self, f"b{i}_pw")(out)))
        return self.linear(avg_pool(out, 2).flatten(1))


# ---------------------------------------------------------------- EfficientNetB0


class MBConv(nn.Module):
    """Reference ``efficientnet.py`` Block:16-72: a 1x1 expansion, a
    depthwise convolution, squeeze-excitation (``se1``/``se2``, float32),
    a 1x1 projection, dropout with one keep per (row, channel), and at
    stride 1 a shortcut (a 1x1 convolution and BatchNorm where the width
    changes)."""

    def __init__(self, in_planes: int, out_planes: int, kernel: int, stride: int, expansion: int,
                 se_ratio: float = 0.25, drop_rate: float = 0.2):
        super().__init__()
        planes = expansion * in_planes
        self.out_planes, self.stride = out_planes, stride
        self.conv1 = _convb(in_planes, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _convb(planes, planes, kernel, stride, groups=planes)
        self.bn2 = BatchNorm2d(planes)
        se_planes = max(1, int(planes * se_ratio))
        self.se1 = nn.Conv2d(planes, se_planes, 1)
        self.se2 = nn.Conv2d(se_planes, planes, 1)
        self.conv3 = _convb(planes, out_planes, 1)
        self.bn3 = BatchNorm2d(out_planes)
        self.dropout = Dropout(drop_rate)
        if stride == 1 and in_planes != out_planes:
            self.shortcut = _convb(in_planes, out_planes, 1)
            self.shortcut_bn = BatchNorm2d(out_planes)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = _swish(self.bn1(self.conv1(x)))
        out = _swish(self.bn2(self.conv2(out)))
        w = _swish(self.se1(out.mean(dim=(2, 3), keepdim=True)))  # float32: bn2's output
        out = out * torch.sigmoid(self.se2(w))
        out = self.bn3(self.conv3(out))
        if self.dropout.live and mask is None:
            mask = self.dropout.draw_mask((out.shape[0], out.shape[1], 1, 1), generator, out.device)
        out = self.dropout(out, mask)
        if self.stride == 1:
            out = out + (self.shortcut_bn(self.shortcut(x)) if hasattr(self, "shortcut") else x)
        return out


# (expansion, out_planes, num_blocks, kernel, stride) -- reference efficientnet.py:103-114
EFFICIENTNET_CFG = ((1, 16, 1, 3, 1), (6, 24, 2, 3, 2), (6, 40, 2, 5, 2), (6, 80, 3, 3, 2),
                    (6, 112, 3, 5, 1), (6, 192, 4, 5, 2), (6, 320, 1, 3, 1))


class EfficientNetB0(nn.Module):
    def __init__(self, num_classes: int = 10, input_size: int = 32, in_channels: int = 3,
                 cfg: Sequence = EFFICIENTNET_CFG):
        super().__init__()
        self.conv1 = _convb(in_channels, 32)
        self.bn1 = BatchNorm2d(32)
        cin, i = 32, 0
        for expansion, planes, nblocks, kernel, stride in cfg:
            for j in range(nblocks):
                setattr(self, f"block{i}", MBConv(cin, planes, kernel, stride if j == 0 else 1, expansion))
                cin, i = planes, i + 1
        self.num_blocks = i
        self.linear = Linear(cin, num_classes)

    def blocks(self) -> List[MBConv]:
        return [getattr(self, f"block{i}") for i in range(self.num_blocks)]

    def mask_shapes(self, n: int) -> List[Tuple[int, ...]]:
        """The shapes of a forward's dropout masks on ``n`` rows, one a block."""
        return [(n, b.out_planes, 1, 1) for b in self.blocks()]

    def draw_masks(self, n: int, generator: Optional[torch.Generator], device) -> List[torch.Tensor]:
        return [b.dropout.draw_mask(s, generator, device) for b, s in zip(self.blocks(), self.mask_shapes(n))]

    def forward(self, x: torch.Tensor, masks: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = _swish(self.bn1(self.conv1(x)))
        for i, block in enumerate(self.blocks()):
            out = block(out, None if masks is None else masks[i], generator)
        return self.linear(out.mean(dim=(2, 3)))


# ---------------------------------------------------------------- GoogLeNet


class Inception(nn.Module):
    """Reference ``googlenet.py:7-55``: four branches (1x1; 1x1 then 3x3;
    1x1 then two 3x3s; a 3x3 max pool then 1x1), each convolution float32
    with bias, BatchNorm and ReLU, concatenated."""

    def __init__(self, in_planes: int, n1x1: int, n3x3red: int, n3x3: int, n5x5red: int, n5x5: int,
                 pool_planes: int):
        super().__init__()
        self.out_planes = n1x1 + n3x3 + n5x5 + pool_planes
        for name, cin, cout, k in (("b1", in_planes, n1x1, 1), ("b2a", in_planes, n3x3red, 1),
                                   ("b2b", n3x3red, n3x3, 3), ("b3a", in_planes, n5x5red, 1),
                                   ("b3b", n5x5red, n5x5, 3), ("b3c", n5x5, n5x5, 3),
                                   ("b4", in_planes, pool_planes, 1)):
            setattr(self, name, nn.Conv2d(cin, cout, k, 1, (k - 1) // 2))
            setattr(self, f"{name}_bn", BatchNorm2d(cout))

    def _cbr(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.relu(getattr(self, f"{name}_bn")(getattr(self, name)(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self._cbr(x, "b1")
        y2 = self._cbr(self._cbr(x, "b2a"), "b2b")
        y3 = self._cbr(self._cbr(self._cbr(x, "b3a"), "b3b"), "b3c")
        y4 = self._cbr(F.max_pool2d(x, 3, 1, 1), "b4")
        return torch.cat([y1, y2, y3, y4], 1)


# (name, n1x1, n3x3red, n3x3, n5x5red, n5x5, pool_planes), "M" a 3x3 max pool of stride 2
GOOGLENET_CFG = (("a3", 64, 96, 128, 16, 32, 32), ("b3", 128, 128, 192, 32, 96, 64), "M",
                 ("a4", 192, 96, 208, 16, 48, 64), ("b4", 160, 112, 224, 24, 64, 64),
                 ("c4", 128, 128, 256, 24, 64, 64), ("d4", 112, 144, 288, 32, 64, 64),
                 ("e4", 256, 160, 320, 32, 128, 128), "M",
                 ("a5", 256, 160, 320, 32, 128, 128), ("b5", 384, 192, 384, 48, 128, 128))


class GoogLeNet(nn.Module):
    def __init__(self, num_classes: int = 10, input_size: int = 32, in_channels: int = 3):
        super().__init__()
        self.pre = nn.Conv2d(in_channels, 192, 3, 1, 1)
        self.pre_bn = BatchNorm2d(192)
        cin, side = 192, input_size
        for item in GOOGLENET_CFG:
            if item == "M":
                side = _down(side)
                continue
            block = Inception(cin, *item[1:])
            setattr(self, item[0], block)
            cin = block.out_planes
        self.linear = _head(cin, side, 8, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.pre_bn(self.pre(x)))
        for item in GOOGLENET_CFG:
            out = F.max_pool2d(out, 3, 2, 1) if item == "M" else getattr(self, item[0])(out)
        return self.linear(avg_pool(out, 8).flatten(1))


# ---------------------------------------------------------------- DPN


class DPNBottleneck(nn.Module):
    """Reference ``dpn.py:8-37``: a 1x1, a 32-group 3x3 and a 1x1
    convolution to ``out_planes + dense_depth``; the residual path adds the
    first ``out_planes`` channels, the dense path concatenates the rest."""

    def __init__(self, cin: int, in_planes: int, out_planes: int, dense_depth: int, stride: int,
                 first_layer: bool):
        super().__init__()
        self.out_planes = out_planes
        width = out_planes + dense_depth
        self.conv1 = _convb(cin, in_planes, 1)
        self.bn1 = BatchNorm2d(in_planes)
        self.conv2 = _convb(in_planes, in_planes, 3, stride, groups=32)
        self.bn2 = BatchNorm2d(in_planes)
        self.conv3 = _convb(in_planes, width, 1)
        self.bn3 = BatchNorm2d(width)
        if first_layer:
            self.shortcut = _convb(cin, width, 1, stride)
            self.shortcut_bn = BatchNorm2d(width)
        self.channels = (width if first_layer else cin) + dense_depth  # of the output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        sc = self.shortcut_bn(self.shortcut(x)) if hasattr(self, "shortcut") else x
        d = self.out_planes
        return F.relu(torch.cat([sc[:, :d] + out[:, :d], sc[:, d:], out[:, d:]], 1))


class DPN(nn.Module):
    def __init__(self, num_classes: int = 10, input_size: int = 32, in_channels: int = 3,
                 in_planes: Sequence[int] = (96, 192, 384, 768), out_planes: Sequence[int] = (256, 512, 1024, 2048),
                 num_blocks: Sequence[int] = (2, 2, 2, 2), dense_depth: Sequence[int] = (16, 32, 24, 128)):
        super().__init__()
        self.num_blocks = tuple(num_blocks)
        self.conv1 = _convb(in_channels, 64)
        self.bn1 = BatchNorm2d(64)
        cin, side = 64, input_size
        for stage in range(4):
            for i in range(num_blocks[stage]):
                stride = 2 if stage > 0 and i == 0 else 1
                block = DPNBottleneck(cin, in_planes[stage], out_planes[stage], dense_depth[stage], stride, i == 0)
                setattr(self, f"s{stage}_{i}", block)
                cin, side = block.channels, _down(side) if stride == 2 else side
        self.linear = _head(cin, side, 4, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        for stage, n in enumerate(self.num_blocks):
            for i in range(n):
                out = getattr(self, f"s{stage}_{i}")(out)
        return self.linear(avg_pool(out, 4).flatten(1))


def dpn26(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> DPN:
    return DPN(num_classes, input_size, in_channels)


def dpn92(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> DPN:
    return DPN(num_classes, input_size, in_channels, num_blocks=(3, 4, 20, 3))


# ---------------------------------------------------------------- SENet


class SEPreActBlock(nn.Module):
    """Reference ``senet.py`` PreActBlock:46-76: a pre-activation block
    whose output is scaled per channel by squeeze-excitation (``fc1``,
    ``fc2``: float32 1x1 convolutions on the mean of ``conv2``'s map, which
    Flax promotes to float32, so the block's output is float32)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = BatchNorm2d(in_planes)
        if stride != 1 or in_planes != planes:
            self.shortcut = _convb(in_planes, planes, 1, stride)
        self.conv1 = _convb(in_planes, planes, 3, stride)
        self.bn2 = BatchNorm2d(planes)
        self.conv2 = _convb(planes, planes, 3)
        self.fc1 = nn.Conv2d(planes, planes // 16, 1)
        self.fc2 = nn.Conv2d(planes // 16, planes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(x))
        sc = self.shortcut(out) if hasattr(self, "shortcut") else x
        out = self.conv1(out)
        out = self.conv2(F.relu(self.bn2(out)))
        w = out.mean(dim=(2, 3), keepdim=True)  # in conv2's dtype; Flax promotes it with fc1's kernel
        w = F.relu(self.fc1(w.to(torch.promote_types(w.dtype, self.fc1.weight.dtype))))
        w = torch.sigmoid(self.fc2(w))
        return out * w + sc


class SENet18(nn.Module):
    def __init__(self, num_classes: int = 10, input_size: int = 32, in_channels: int = 3):
        super().__init__()
        self.conv1 = _convb(in_channels, 64)
        self.bn1 = BatchNorm2d(64)
        cin, side = 64, input_size
        for stage, (planes, stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2)), 1):
            for i in range(2):
                s = stride if i == 0 else 1
                setattr(self, f"layer{stage}_{i}", SEPreActBlock(cin, planes, s))
                cin, side = planes, _down(side) if s == 2 else side
        self.linear = _head(cin, side, 4, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        for stage in range(1, 5):
            for i in range(2):
                out = getattr(self, f"layer{stage}_{i}")(out)
        return self.linear(avg_pool(out, 4).flatten(1))


# ---------------------------------------------------------------- ResNeXt


class ResNeXtBlock(nn.Module):
    """Reference ``resnext.py`` Block: 1x1, ``cardinality``-group 3x3, 1x1
    to ``expansion`` x the group width, and a projection shortcut
    (``shortcut``, ``shortcut_bn``) where the stride or the width changes."""

    def __init__(self, in_planes: int, cardinality: int, bottleneck_width: int, stride: int = 1,
                 expansion: int = 2):
        super().__init__()
        gw = cardinality * bottleneck_width
        self.out_planes = expansion * gw
        self.conv1 = _convb(in_planes, gw, 1)
        self.bn1 = BatchNorm2d(gw)
        self.conv2 = _convb(gw, gw, 3, stride, groups=cardinality)
        self.bn2 = BatchNorm2d(gw)
        self.conv3 = _convb(gw, self.out_planes, 1)
        self.bn3 = BatchNorm2d(self.out_planes)
        if stride != 1 or in_planes != self.out_planes:
            self.shortcut = _convb(in_planes, self.out_planes, 1, stride)
            self.shortcut_bn = BatchNorm2d(self.out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        sc = self.shortcut_bn(self.shortcut(x)) if hasattr(self, "shortcut") else x
        return F.relu(out + sc)


class ResNeXt29(nn.Module):
    """Reference ``resnext.py:44-79``: a 1x1 stem, three stages whose group
    width doubles a stage, an average pool of 8."""

    def __init__(self, num_classes: int = 10, input_size: int = 32, in_channels: int = 3, cardinality: int = 2,
                 bottleneck_width: int = 64, num_blocks: Sequence[int] = (3, 3, 3)):
        super().__init__()
        self.num_blocks = tuple(num_blocks)
        self.conv1 = _convb(in_channels, 64, 1)
        self.bn1 = BatchNorm2d(64)
        cin, side, width = 64, input_size, bottleneck_width
        for stage, nb in enumerate(num_blocks):
            for i in range(nb):
                stride = 2 if stage > 0 and i == 0 else 1
                block = ResNeXtBlock(cin, cardinality, width, stride)
                setattr(self, f"layer{stage + 1}_{i}", block)
                cin, side = block.out_planes, _down(side) if stride == 2 else side
            width *= 2
        self.linear = _head(cin, side, 8, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        for stage, nb in enumerate(self.num_blocks):
            for i in range(nb):
                out = getattr(self, f"layer{stage + 1}_{i}")(out)
        return self.linear(avg_pool(out, 8).flatten(1))


def resnext29_2x64d(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> ResNeXt29:
    return ResNeXt29(num_classes, input_size, in_channels, cardinality=2, bottleneck_width=64)


def resnext29_32x4d(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> ResNeXt29:
    return ResNeXt29(num_classes, input_size, in_channels, cardinality=32, bottleneck_width=4)


# ---------------------------------------------------------------- ShuffleNet (v1)


class ShuffleBottleneck(nn.Module):
    """Reference ``shufflenet.py:23-52``, as the JAX package fixes it (an
    integer bottleneck width): a grouped 1x1 (one group on the 24-channel
    stem), a channel shuffle, a depthwise 3x3, a grouped 1x1; at stride 2
    the input's 3x3 average pool (padding counted in the mean, as in Flax)
    is concatenated, at stride 1 added."""

    def __init__(self, in_planes: int, out_planes: int, stride: int, groups: int):
        super().__init__()
        mid = out_planes // 4
        self.stride, self.g = stride, 1 if in_planes == 24 else groups
        self.conv1 = _convb(in_planes, mid, 1, groups=self.g)
        self.bn1 = BatchNorm2d(mid)
        self.conv2 = _convb(mid, mid, 3, stride, groups=mid)
        self.bn2 = BatchNorm2d(mid)
        self.conv3 = _convb(mid, out_planes, 1, groups=groups)
        self.bn3 = BatchNorm2d(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = channel_shuffle(out, self.g)
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.stride == 2:
            return F.relu(torch.cat([out, F.avg_pool2d(x, 3, 2, 1)], 1))
        return F.relu(out + x)


class ShuffleNetG2(nn.Module):
    def __init__(self, num_classes: int = 10, input_size: int = 32, in_channels: int = 3,
                 out_planes: Sequence[int] = (200, 400, 800), num_blocks: Sequence[int] = (4, 8, 4), groups: int = 2):
        super().__init__()
        self.num_blocks = tuple(num_blocks)
        self.conv1 = _convb(in_channels, 24, 1)
        self.bn1 = BatchNorm2d(24)
        cin, side = 24, input_size
        for stage in range(3):
            for i in range(num_blocks[stage]):
                cat_planes = cin if i == 0 else 0
                setattr(self, f"s{stage}_{i}",
                        ShuffleBottleneck(cin, out_planes[stage] - cat_planes, 2 if i == 0 else 1, groups))
                cin, side = out_planes[stage], _down(side) if i == 0 else side
        self.linear = _head(cin, side, 4, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        for stage, nb in enumerate(self.num_blocks):
            for i in range(nb):
                out = getattr(self, f"s{stage}_{i}")(out)
        return self.linear(avg_pool(out, 4).flatten(1))


# ---------------------------------------------------------------- ShuffleNetV2


class ShuffleV2Basic(nn.Module):
    """Reference ``shufflenetv2.py:33-56``: split the channels in halves,
    1x1-depthwise 3x3-1x1 on the second, concatenate, shuffle in 2 groups."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels // 2
        self.conv1 = _convb(c, c, 1)
        self.bn1 = BatchNorm2d(c)
        self.conv2 = _convb(c, c, 3, groups=c)
        self.bn2 = BatchNorm2d(c)
        self.conv3 = _convb(c, c, 1)
        self.bn3 = BatchNorm2d(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1] // 2
        x1, x2 = x[:, :c], x[:, c:]
        out = F.relu(self.bn1(self.conv1(x2)))
        out = self.bn2(self.conv2(out))
        out = F.relu(self.bn3(self.conv3(out)))
        return channel_shuffle(torch.cat([x1, out], 1), 2)


class ShuffleV2Down(nn.Module):
    """Reference ``shufflenetv2.py:58-93``: two stride-2 branches (depthwise
    then 1x1; 1x1, depthwise, 1x1), concatenated and shuffled."""

    def __init__(self, c_in: int, out_channels: int):
        super().__init__()
        mid = out_channels // 2
        self.conv1 = _convb(c_in, c_in, 3, 2, groups=c_in)
        self.bn1 = BatchNorm2d(c_in)
        self.conv2 = _convb(c_in, mid, 1)
        self.bn2 = BatchNorm2d(mid)
        self.conv3 = _convb(c_in, mid, 1)
        self.bn3 = BatchNorm2d(mid)
        self.conv4 = _convb(mid, mid, 3, 2, groups=mid)
        self.bn4 = BatchNorm2d(mid)
        self.conv5 = _convb(mid, mid, 1)
        self.bn5 = BatchNorm2d(mid)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        left = self.bn1(self.conv1(x))
        left = F.relu(self.bn2(self.conv2(left)))
        right = F.relu(self.bn3(self.conv3(x)))
        right = self.bn4(self.conv4(right))
        right = F.relu(self.bn5(self.conv5(right)))
        return channel_shuffle(torch.cat([left, right], 1), 2)


class ShuffleNetV2(nn.Module):
    def __init__(self, num_classes: int = 10, input_size: int = 32, in_channels: int = 3,
                 out_channels: Sequence[int] = (116, 232, 464, 1024), num_blocks: Sequence[int] = (3, 7, 3)):
        super().__init__()
        self.num_blocks = tuple(num_blocks)
        self.conv1 = _convb(in_channels, 24)
        self.bn1 = BatchNorm2d(24)
        cin, side = 24, input_size
        for stage in range(3):
            setattr(self, f"down{stage}", ShuffleV2Down(cin, out_channels[stage]))
            cin, side = out_channels[stage] // 2 * 2, _down(side)
            for i in range(num_blocks[stage]):
                setattr(self, f"s{stage}_{i}", ShuffleV2Basic(cin))
        self.conv2 = _convb(cin, out_channels[3], 1)
        self.bn2 = BatchNorm2d(out_channels[3])
        self.linear = _head(out_channels[3], side, 4, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        for stage, nb in enumerate(self.num_blocks):
            out = getattr(self, f"down{stage}")(out)
            for i in range(nb):
                out = getattr(self, f"s{stage}_{i}")(out)
        out = F.relu(self.bn2(self.conv2(out)))
        return self.linear(avg_pool(out, 4).flatten(1))


# ---------------------------------------------------------------- PNASNet


class SepConv(nn.Module):
    """Reference ``pnasnet.py:11-22``: a convolution grouped by its input
    channels, then BatchNorm."""

    def __init__(self, in_planes: int, out_planes: int, kernel: int, stride: int):
        super().__init__()
        self.conv1 = _convb(in_planes, out_planes, kernel, stride, groups=in_planes)
        self.bn1 = BatchNorm2d(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn1(self.conv1(x))


class CellA(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.sep1 = SepConv(in_planes, out_planes, 7, stride)
        if stride == 2:
            self.conv1 = _convb(in_planes, out_planes, 1)
            self.bn1 = BatchNorm2d(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self.sep1(x)
        y2 = F.max_pool2d(x, 3, self.stride, 1)
        if self.stride == 2:
            y2 = self.bn1(self.conv1(y2))
        return F.relu(y1 + y2)


class CellB(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.sep1 = SepConv(in_planes, out_planes, 7, stride)
        self.sep2 = SepConv(in_planes, out_planes, 3, stride)
        if stride == 2:
            self.conv1 = _convb(in_planes, out_planes, 1)
            self.bn1 = BatchNorm2d(out_planes)
        self.sep3 = SepConv(in_planes, out_planes, 5, stride)
        self.conv2 = _convb(2 * out_planes, out_planes, 1)
        self.bn2 = BatchNorm2d(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1, y2 = self.sep1(x), self.sep2(x)
        y3 = F.max_pool2d(x, 3, self.stride, 1)
        if self.stride == 2:
            y3 = self.bn1(self.conv1(y3))
        y4 = self.sep3(x)
        b = torch.cat([F.relu(y1 + y2), F.relu(y3 + y4)], 1)
        return F.relu(self.bn2(self.conv2(b)))


class PNASNet(nn.Module):
    """Reference ``pnasnet.py``: a 3x3 stem, then 6 cells, a stride-2 cell
    doubling the width, 6 cells, another, 6 cells; an average pool of 8."""

    def __init__(self, num_classes: int = 10, input_size: int = 32, in_channels: int = 3, cell: str = "A",
                 num_planes: int = 44):
        super().__init__()
        cell_cls = CellA if cell == "A" else CellB
        p = num_planes
        self.conv1 = _convb(in_channels, p)
        self.bn1 = BatchNorm2d(p)
        cin, side, idx = p, input_size, 0
        for planes, cells in ((p, 6), (p * 2, 1), (p * 2, 6), (p * 4, 1), (p * 4, 6)):
            stride = 2 if cells == 1 else 1
            for _ in range(cells):
                setattr(self, f"cell{idx}", cell_cls(cin, planes, stride))
                cin, side, idx = planes, _down(side) if stride == 2 else side, idx + 1
        self.num_cells = idx
        self.linear = _head(cin, side, 8, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        for i in range(self.num_cells):
            out = getattr(self, f"cell{i}")(out)
        return self.linear(avg_pool(out, 8).flatten(1))


def pnasnet_a(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> PNASNet:
    return PNASNet(num_classes, input_size, in_channels, cell="A", num_planes=44)


def pnasnet_b(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> PNASNet:
    return PNASNet(num_classes, input_size, in_channels, cell="B", num_planes=32)
