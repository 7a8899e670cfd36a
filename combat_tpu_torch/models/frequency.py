"""Frequency-domain backdoor detectors (NCHW; the port of
``combat_tpu/models/frequency.py``).

Reference ``defenses/frequency_based/model.py``:
  * :class:`FrequencyModel` (``:8-52``): six conv-ELU-BN triplets (the
    activation comes before the BatchNorm), a 2x2 max pool and dropout after
    each pair, a linear head.  The input is the 2-D DCT of the uint8 image
    (``ops.dct.detector_features``).  The head flattens the NCHW map in
    PyTorch's (C, H, W) order; ``checkpoint/convert.py`` permutes the JAX
    package's (H, W, C)-ordered kernel to match.  In a ``--compute_dtype``
    run the DCT input stays float32 (``layers.py``).
  * :func:`frequency_model_dropout` (``:55-67``, ``--F_model
    original_dropout``): its dropout stays live in eval mode, so after
    ``freeze``.
  * :class:`FrequencyModelDropoutEnsemble` (``:70-84``, ``--F_model
    original_dropout_ensemble``): one shared ``body`` run ``num_ensemble``
    times with fresh masks, the logits averaged.

A forward's dropout masks (bool, True = kept) can be passed in, one for
each dropout in call order (:meth:`FrequencyModel.mask_shapes` gives their
shapes), so a test can inject the masks Flax drew; without them they are
drawn from ``generator``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, Conv2d, Dropout, Linear

Masks = Optional[Sequence[torch.Tensor]]


class FrequencyModel(nn.Module):
    def __init__(
        self,
        num_classes: int = 2,
        dropout: float = 0.2,
        input_size: int = 32,
        in_channels: int = 3,
        dropout_always_on: bool = False,
    ):
        super().__init__()
        self.input_size = input_size
        cin = in_channels
        for i, planes in enumerate((32, 32, 64, 64, 128, 128)):
            setattr(self, f"conv{i}", Conv2d(cin, planes, 3, 1, 1))
            setattr(self, f"bn{i}", BatchNorm2d(planes))
            cin = planes
        self.dropout = Dropout(dropout, always_on=dropout_always_on)
        side = input_size // 8
        self.linear = Linear(128 * side * side, num_classes)

    def mask_shapes(self, n: int) -> List[Tuple[int, ...]]:
        """The shapes of a forward's three dropout masks on ``n`` rows."""
        side = self.input_size
        shapes = []
        for planes in (32, 64, 128):
            side //= 2
            shapes.append((n, planes, side, side))
        return shapes

    def draw_masks(self, n: int, generator: Optional[torch.Generator], device) -> List[torch.Tensor]:
        return [self.dropout.draw_mask(s, generator, device) for s in self.mask_shapes(n)]

    def forward(self, x: torch.Tensor, masks: Masks = None, generator: Optional[torch.Generator] = None):
        for i in range(6):
            x = getattr(self, f"bn{i}")(F.elu(getattr(self, f"conv{i}")(x)))
            if i % 2 == 1:
                x = self.dropout(F.max_pool2d(x, 2), None if masks is None else masks[i // 2], generator)
        return self.linear(x.flatten(1))


def frequency_model_dropout(
    num_classes: int = 2, dropout: float = 0.5, input_size: int = 32, in_channels: int = 3
) -> FrequencyModel:
    return FrequencyModel(num_classes, dropout, input_size, in_channels, dropout_always_on=True)


class FrequencyModelDropoutEnsemble(nn.Module):
    def __init__(
        self, num_classes: int = 2, dropout: float = 0.5, num_ensemble: int = 3, input_size: int = 32,
        in_channels: int = 3,
    ):
        super().__init__()
        self.num_ensemble = num_ensemble
        self.body = frequency_model_dropout(num_classes, dropout, input_size, in_channels)

    def mask_shapes(self, n: int) -> List[Tuple[int, ...]]:
        return self.body.mask_shapes(n) * self.num_ensemble

    def draw_masks(self, n: int, generator: Optional[torch.Generator], device) -> List[torch.Tensor]:
        return [m for _ in range(self.num_ensemble) for m in self.body.draw_masks(n, generator, device)]

    def forward(self, x: torch.Tensor, masks: Masks = None, generator: Optional[torch.Generator] = None):
        k = len(self.body.mask_shapes(0))
        outs = [self.body(x, None if masks is None else masks[i * k:(i + 1) * k], generator)
                for i in range(self.num_ensemble)]
        return torch.stack(outs, dim=1).mean(dim=1)
