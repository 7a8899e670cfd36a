"""mnist's default classifier (the port of ``combat_tpu/models/misc.py::NetC_MNIST``).

Reference ``networks/models.py:712-738``: four convolutions (5x5 valid,
3x3 stride 2, 5x5 valid, 3x3 stride 2: 28 -> 24 -> 12 -> 8 -> 4 px), each
followed by ReLU and dropout(0.3), a linear to 512, ReLU, dropout, a linear
head.  The dropout is live in train mode only; its masks can be passed in
(``masks``, one a dropout in call order) or drawn from ``generator``.

The JAX package's convolutions here pass no ``dtype=`` and its linears do,
so in a ``--compute_dtype`` run the convolutions stay float32
(``torch.nn.Conv2d``, which ``layers.set_compute_dtype`` leaves alone) and
the linears compute in the low dtype.  ``linear6`` reads the flattened
4 x 4 x 64 map in PyTorch's (C, H, W) order (``checkpoint/convert.py``
permutes the kernel).

The module's other classes (NetC_GTRSB, NetC_MNIST2/3, NetC_CelebA, AE) are
reached by no entry point and are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dropout, Linear

# (out channels, kernel, stride, padding) of conv1-conv4
_CONVS = ((32, 5, 1, 0), (32, 3, 2, 1), (64, 5, 1, 0), (64, 3, 2, 1))


class NetC_MNIST(nn.Module):
    def __init__(self, num_classes: int = 10, input_size: int = 28, in_channels: int = 1):
        super().__init__()
        cin, side = in_channels, input_size
        for i, (cout, k, s, p) in enumerate(_CONVS, start=1):
            setattr(self, f"conv{i}", nn.Conv2d(cin, cout, k, s, p))
            cin, side = cout, (side + 2 * p - k) // s + 1
        self.linear6 = Linear(cin * side * side, 512)
        self.linear9 = Linear(512, num_classes)
        self.dropout = Dropout(0.3)

    def forward(
        self,
        x: torch.Tensor,
        masks: Optional[Sequence[torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        masks = list(masks) if masks is not None else [None] * 5
        for i in range(4):
            x = self.dropout(F.relu(getattr(self, f"conv{i + 1}")(x)), masks[i], generator)
        x = self.dropout(F.relu(self.linear6(x.flatten(1))), masks[4], generator)
        return self.linear9(x)
