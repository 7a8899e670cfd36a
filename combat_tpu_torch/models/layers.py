"""Shared layers (the port of ``combat_tpu/models/layers.py``).

Convolutions and linears keep PyTorch's default init, which is what the JAX
package replicates.  :class:`BatchNorm2d` updates its running variance with
the biased batch variance, as Flax does (torch's own module uses the
unbiased one), so converted weights train to the same statistics.

Mixed precision is the JAX package's recipe (``combat_tpu/models/layers.py``,
Flax's ``dtype=`` attribute), with explicit casts at its rounding points:
:class:`Conv2d` and :class:`Linear` compute in their ``compute_dtype``
(input, weight and bias cast to it, output in it) while the parameters stay
float32; :class:`BatchNorm2d` takes its input in float32 and returns float32,
as Flax's BatchNorm promotes a bfloat16 input with its float32 scale;
:func:`instance_norm` keeps its statistics in float32 and returns the input's
dtype.  :func:`set_compute_dtype` sets a built model's dtype (the registry
does, from ``cfg.compute_dtype``); it is not process state, and ``None`` is
float32 throughout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class _GuidedReLU(torch.autograd.Function):
    """ReLU whose backward passes only positive gradients through positive
    activations (Guided Backpropagation, reference
    ``defenses/gradcam/gradcam.py:201-271``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp_min(0.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x > 0) & (g > 0), g, torch.zeros_like(g))


def guided_relu(x: torch.Tensor) -> torch.Tensor:
    return _GuidedReLU.apply(x)


# --compute_dtype's names and the dtype each gives the convolutions and
# linears (None: float32 throughout).  The JAX package's set_compute_dtype
# takes any dtype name; these are the float types its recipe is meant for.
COMPUTE_DTYPES = {"float32": None, "f32": None, "": None, "bfloat16": torch.bfloat16, "float16": torch.float16}


def parse_compute_dtype(name: str) -> Optional[torch.dtype]:
    """The dtype ``--compute_dtype name`` selects; a ``ValueError`` naming
    the accepted names for any other."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"--compute_dtype takes one of {sorted(COMPUTE_DTYPES)}, got {name!r}")
    return COMPUTE_DTYPES[name]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` when it is set (Flax's
    ``nn.Conv`` with ``dtype=``); the state-dict keys are ``nn.Conv2d``'s."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt))


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` when it is set (Flax's
    ``nn.Dense`` with ``dtype=``)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def set_compute_dtype(model: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Every :class:`Conv2d` and :class:`Linear` of ``model`` computes in
    ``dtype`` (``None``: float32)."""
    for m in model.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.compute_dtype = dtype
    return model


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (momentum 0.1, eps 1e-5, affine) whose running
    variance takes the biased batch variance, matching the JAX package.
    It normalizes in float32 and returns float32 for any input dtype."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``nn.InstanceNorm2d`` defaults (no affine, no running stats), with the
    statistics in float32."""
    return F.instance_norm(x.float(), eps=eps).to(x.dtype)
