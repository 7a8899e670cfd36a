"""Frequency-domain backdoor detector (NCHW; the port of
``combat_tpu/models/frequency.py::FrequencyModel``).

Reference ``defenses/frequency_based/model.py:8-52``: six conv-ELU-BN
triplets (the activation comes before the BatchNorm), a 2x2 max pool and
dropout after each pair, a linear head.  The input is the 2-D DCT of the
uint8 image (``ops.dct.detector_features``).  The head flattens the NCHW map
in PyTorch's (C, H, W) order; ``checkpoint/convert.py`` permutes the JAX
package's (H, W, C)-ordered kernel to match.  In a ``--compute_dtype``
run the DCT input stays float32 (``layers.py``).
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, Conv2d, Linear


class FrequencyModel(nn.Module):
    def __init__(self, num_classes: int = 2, dropout: float = 0.2, input_size: int = 32, in_channels: int = 3):
        super().__init__()
        cin = in_channels
        for i, planes in enumerate((32, 32, 64, 64, 128, 128)):
            setattr(self, f"conv{i}", Conv2d(cin, planes, 3, 1, 1))
            setattr(self, f"bn{i}", BatchNorm2d(planes))
            cin = planes
        self.dropout = nn.Dropout(dropout)
        side = input_size // 8
        self.linear = Linear(128 * side * side, num_classes)

    def forward(self, x):
        for i in range(6):
            x = getattr(self, f"bn{i}")(F.elu(getattr(self, f"conv{i}")(x)))
            if i % 2 == 1:
                x = self.dropout(F.max_pool2d(x, 2))
        return self.linear(x.flatten(1))
