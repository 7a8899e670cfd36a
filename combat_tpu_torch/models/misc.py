"""The reference's auxiliary networks (NCHW; the port of ``combat_tpu/models/misc.py``).

Reference ``networks/models.py`` and ``networks/blocks.py``: the AE
autoencoder (``models.py:89-152``), NetC_GTRSB (``:635-660``), mnist's
default NetC_MNIST (``:712-738``), NetC_MNIST2/3 (``:765-834``),
NetC_CelebA (``:870-902``), and the +-0.5 ``Normalize``/``Denormalize``
channel maps (``:15-86``), which are affine functions here.  Module names
follow the JAX models' (``block3``, ``layer2``, ``up1_conv``).

Precision (``layers.py``): the JAX package's convolutions here pass no
``dtype=`` and its linears do, so in a ``--compute_dtype`` run the
convolutions (``torch.nn.Conv2d``, ``ConvTranspose2d``) stay float32 and
the linears compute in the low dtype.  A linear that reads a flattened map
takes it in PyTorch's (C, H, W) order (``checkpoint/convert.py`` permutes
the kernel).

Dropout (p 0.3) is live in train mode only; a forward's masks can be passed
in (``masks``, one a dropout in call order; ``mask_shapes``) or drawn from
``generator``.  The JAX C-steps pass no dropout rng, so training one of
these classifiers stops in both packages (``train/steps.py::
refuse_train_dropout``).  The BatchNorm of ``Conv2dBlock`` and the AE has
momentum 0.05 (Flax's 0.95).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, Dropout, Linear

Masks = Optional[Sequence[torch.Tensor]]


def normalize_pm05(x: torch.Tensor) -> torch.Tensor:
    """``Normalize([0.5] * c, [0.5] * c)``: [0, 1] -> [-1, 1]."""
    return (x - 0.5) / 0.5


def denormalize_pm05(x: torch.Tensor) -> torch.Tensor:
    """``Denormalize([0.5] * c, [0.5] * c)``: [-1, 1] -> [0, 1]."""
    return x * 0.5 + 0.5


class _DropoutNet(nn.Module):
    """A classifier whose forward runs ``self.dropout`` at the maps
    :meth:`mask_shapes` lists."""

    def mask_shapes(self, n: int) -> List[Tuple[int, ...]]:
        raise NotImplementedError

    def draw_masks(self, n: int, generator: Optional[torch.Generator], device) -> List[torch.Tensor]:
        return [self.dropout.draw_mask(s, generator, device) for s in self.mask_shapes(n)]


# ---------------------------------------------------------------- NetC_MNIST

# (out channels, kernel, stride, padding) of conv1-conv4
_CONVS = ((32, 5, 1, 0), (32, 3, 2, 1), (64, 5, 1, 0), (64, 3, 2, 1))


class NetC_MNIST(nn.Module):
    """Four convolutions (5x5 valid, 3x3 stride 2, 5x5 valid, 3x3 stride 2:
    28 -> 24 -> 12 -> 8 -> 4 px), each followed by ReLU and dropout, a
    linear to 512, ReLU, dropout, a linear head."""

    def __init__(self, num_classes: int = 10, input_size: int = 28, in_channels: int = 1):
        super().__init__()
        cin, side = in_channels, input_size
        for i, (cout, k, s, p) in enumerate(_CONVS, start=1):
            setattr(self, f"conv{i}", nn.Conv2d(cin, cout, k, s, p))
            cin, side = cout, (side + 2 * p - k) // s + 1
        self.linear6 = Linear(cin * side * side, 512)
        self.linear9 = Linear(512, num_classes)
        self.dropout = Dropout(0.3)

    def forward(self, x: torch.Tensor, masks: Masks = None, generator: Optional[torch.Generator] = None):
        masks = list(masks) if masks is not None else [None] * 5
        for i in range(4):
            x = self.dropout(F.relu(getattr(self, f"conv{i + 1}")(x)), masks[i], generator)
        x = self.dropout(F.relu(self.linear6(x.flatten(1))), masks[4], generator)
        return self.linear9(x)


# ---------------------------------------------------------------- AE


class Conv2dBlock(nn.Module):
    """conv (with bias) - BatchNorm (momentum 0.05) - ReLU (reference
    ``networks/blocks.py:4-16``; its options to leave out the BatchNorm or
    the ReLU are used by no network)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1, padding: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride, padding)
        self.bn = BatchNorm2d(features, momentum=0.05)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class Encoder(nn.Module):
    """Three 4x4 stride-2 ``Conv2dBlock``s to 12, 24, 48 channels."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        cin = in_channels
        for i, c in enumerate((12, 24, 48), start=1):
            setattr(self, f"down{i}", Conv2dBlock(cin, c, kernel=4, stride=2))
            cin = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in (1, 2, 3):
            x = getattr(self, f"down{i}")(x)
        return x


class Decoder(nn.Module):
    """Three 4x4 stride-2 transposed convolutions (48 -> 24 -> 12 -> 3),
    each with BatchNorm, ReLU on the first two, then a sigmoid.  Flax's
    ``ConvTranspose(4, 2, "SAME")`` doubles the map, as ``padding=1`` does
    here; its kernel is not flipped, so ``checkpoint/convert.py`` flips it.
    The init is Flax's: U(+-1/sqrt(16 x in)) kernels, zero biases."""

    def __init__(self, out_channels: int = 3):
        super().__init__()
        cin = 48
        for i, c in enumerate((24, 12, out_channels), start=1):
            conv = nn.ConvTranspose2d(cin, c, 4, 2, 1)
            bound = 1.0 / math.sqrt(16 * cin)
            nn.init.uniform_(conv.weight, -bound, bound)
            nn.init.zeros_(conv.bias)
            setattr(self, f"up{i}_conv", conv)
            setattr(self, f"up{i}_bn", BatchNorm2d(c, momentum=0.05))
            cin = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in (1, 2, 3):
            x = getattr(self, f"up{i}_bn")(getattr(self, f"up{i}_conv")(x))
            if i < 3:
                x = F.relu(x)
        return torch.sigmoid(x)


class AE(nn.Module):
    """The autoencoder, its output normalized to [-1, 1] (reference
    ``models.py:117-152``)."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.encoder = Encoder(in_channels)
        self.decoder = Decoder(3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return normalize_pm05(self.decoder(self.encoder(x)))


# ---------------------------------------------------------------- NetC_GTRSB


class NetC_GTRSB(_DropoutNet):
    """Three pairs of 3x3 ``Conv2dBlock``s (32, 64, 128), each pair followed
    by a 2x2 max pool and dropout, a linear to 512, ReLU, dropout, a linear
    head."""

    def __init__(self, num_classes: int = 43, input_size: int = 32, in_channels: int = 3):
        super().__init__()
        self.input_size = input_size
        cin = in_channels
        for i, c in enumerate((32, 32, 64, 64, 128, 128), start=1):
            setattr(self, f"block{i}", Conv2dBlock(cin, c))
            cin = c
        side = input_size // 8
        self.linear1 = Linear(128 * side * side, 512)
        self.linear11 = Linear(512, num_classes)
        self.dropout = Dropout(0.3)

    def mask_shapes(self, n: int) -> List[Tuple[int, ...]]:
        s = self.input_size
        return [(n, 32, s // 2, s // 2), (n, 64, s // 4, s // 4), (n, 128, s // 8, s // 8), (n, 512)]

    def forward(self, x: torch.Tensor, masks: Masks = None, generator: Optional[torch.Generator] = None):
        masks = list(masks) if masks is not None else [None] * 4
        for pair in range(3):
            x = getattr(self, f"block{2 * pair + 2}")(getattr(self, f"block{2 * pair + 1}")(x))
            x = self.dropout(F.max_pool2d(x, 2), masks[pair], generator)
        x = self.dropout(F.relu(self.linear1(x.flatten(1))), masks[3], generator)
        return self.linear11(x)


# ---------------------------------------------------------------- NetC_MNIST2, NetC_MNIST3


class MNISTBlock(nn.Module):
    """BatchNorm - ReLU - 3x3 conv (no bias), plus a 1x1 conv shortcut of the
    activation where the stride or width changes (reference
    ``models.py:741-762``)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = BatchNorm2d(in_planes)
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Conv2d(in_planes, planes, 1, stride, bias=False)
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(x))
        sc = self.shortcut(out) if hasattr(self, "shortcut") else x
        return self.conv1(out) + sc


class MNISTBlock3(nn.Module):
    """``MNISTBlock`` without the shortcut (reference ``models.py:788-811``)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = BatchNorm2d(in_planes)
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1(F.relu(self.bn1(x)))


def _down(side: int) -> int:
    return (side + 1) // 2  # a 3x3 stride-2 conv with padding 1


class NetC_MNIST2(_DropoutNet):
    """A 3x3 conv and ReLU, three stride-2 ``MNISTBlock``s to 64 channels,
    dropout, a linear to 512, ReLU, dropout, a linear head."""

    def __init__(self, num_classes: int = 10, input_size: int = 28, in_channels: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 32, 3, 1, 1)
        cin, side = 32, input_size
        for i in (2, 3, 4):
            setattr(self, f"layer{i}", MNISTBlock(cin, 64, 2))
            cin, side = 64, _down(side)
        self.side = side
        self.linear6 = Linear(64 * side * side, 512)
        self.linear9 = Linear(512, num_classes)
        self.dropout = Dropout(0.3)

    def mask_shapes(self, n: int) -> List[Tuple[int, ...]]:
        return [(n, 64, self.side, self.side), (n, 512)]

    def forward(self, x: torch.Tensor, masks: Masks = None, generator: Optional[torch.Generator] = None):
        masks = list(masks) if masks is not None else [None] * 2
        x = F.relu(self.conv1(x))
        x = self.layer4(self.layer3(self.layer2(x)))
        x = self.dropout(x, masks[0], generator)
        x = self.dropout(F.relu(self.linear6(x.flatten(1))), masks[1], generator)
        return self.linear9(x)


class NetC_MNIST3(_DropoutNet):
    """A 3x3 stride-2 conv and ReLU, two stride-2 ``MNISTBlock3``s to 64
    channels, a linear to 512, ReLU, dropout, a linear head (the reference's
    Neural Cleanse mnist model)."""

    def __init__(self, num_classes: int = 10, input_size: int = 28, in_channels: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 32, 3, 2, 1)
        self.layer2 = MNISTBlock3(32, 64, 2)
        self.layer3 = MNISTBlock3(64, 64, 2)
        side = _down(_down(_down(input_size)))
        self.linear6 = Linear(64 * side * side, 512)
        self.linear9 = Linear(512, num_classes)
        self.dropout = Dropout(0.3)

    def mask_shapes(self, n: int) -> List[Tuple[int, ...]]:
        return [(n, 512)]

    def forward(self, x: torch.Tensor, masks: Masks = None, generator: Optional[torch.Generator] = None):
        x = self.layer3(self.layer2(F.relu(self.conv1(x))))
        x = F.relu(self.linear6(x.flatten(1)))
        return self.linear9(self.dropout(x, None if masks is None else masks[0], generator))


# ---------------------------------------------------------------- NetC_CelebA


class NetC_CelebA(_DropoutNet):
    """Three 3x3 convs (32, 64, 64), each followed by BatchNorm, ReLU,
    dropout and a 2x2 max pool, then a linear to 128, dropout, a linear
    head (no activation between the linears, as in the reference)."""

    def __init__(self, num_classes: int = 8, input_size: int = 64, in_channels: int = 3):
        super().__init__()
        self.input_size = input_size
        cin = in_channels
        for i, c in enumerate((32, 64, 64), start=1):
            setattr(self, f"conv{i}", nn.Conv2d(cin, c, 3, 1, 1))
            setattr(self, f"bn{i}", BatchNorm2d(c))
            cin = c
        side = input_size // 8
        self.linear12 = Linear(64 * side * side, 128)
        self.linear13 = Linear(128, num_classes)
        self.dropout = Dropout(0.3)

    def mask_shapes(self, n: int) -> List[Tuple[int, ...]]:
        s = self.input_size
        return [(n, 32, s, s), (n, 64, s // 2, s // 2), (n, 64, s // 4, s // 4), (n, 128)]

    def forward(self, x: torch.Tensor, masks: Masks = None, generator: Optional[torch.Generator] = None):
        masks = list(masks) if masks is not None else [None] * 4
        for i in range(3):
            x = F.relu(getattr(self, f"bn{i + 1}")(getattr(self, f"conv{i + 1}")(x)))
            x = F.max_pool2d(self.dropout(x, masks[i], generator), 2)
        x = self.dropout(self.linear12(x.flatten(1)), masks[3], generator)
        return self.linear13(x)
