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
float32 throughout.  A model that should stay float32 in a low-precision run
(the ViTs, NetC_MNIST's convolutions: their Flax layers pass no ``dtype=``)
uses ``torch.nn``'s own layers, which :func:`set_compute_dtype` leaves alone.

:class:`Dropout` is Flax's ``nn.Dropout`` (inverted, ``keep / (1 - p)``) with
its mask passed in or drawn from a ``torch.Generator``; ``always_on`` keeps it
live under ``.eval()``, as the reference's dropout detectors do
(``train/state.py::freeze`` calls ``.eval()``, which would switch
``nn.Dropout`` off).

:class:`FourStageNet` is the forward of the ResNets and PreActResNets and
their defense hooks, split into a trunk and a head for fine-pruning.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

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
    """``nn.BatchNorm2d`` (momentum 0.1 unless given, eps 1e-5, affine)
    whose running variance takes the biased batch variance, matching the JAX
    package; torch's ``momentum`` is 1 minus Flax's.  It normalizes a
    bfloat16 or float16 input in float32 and returns float32; a float64
    model (a test's reference) stays float64."""

    def __init__(self, num_features: int, momentum: float = 0.1):
        super().__init__(num_features, eps=1e-5, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float64:
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


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """Flax's ``nn.avg_pool(x, (w, w), (w, w))``: no padding, the map's
    remainder dropped."""
    return F.avg_pool2d(x, window)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with Flax's epsilon, 1e-6 (torch's default is 1e-5)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)


class Dropout(nn.Module):
    """Flax's ``nn.Dropout``: an element is kept with probability ``1 - p``
    and scaled by ``1 / (1 - p)``.  Live in train mode, and in eval mode too
    when ``always_on``.  ``mask`` (bool, True = kept) is the draw to use;
    without one it is drawn from ``generator``."""

    def __init__(self, p: float, always_on: bool = False):
        super().__init__()
        self.p = p
        self.always_on = always_on

    @property
    def live(self) -> bool:
        return (self.training or self.always_on) and self.p > 0.0

    def draw_mask(self, shape: Sequence[int], generator: Optional[torch.Generator], device) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=generator, device=device) < 1.0 - self.p

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        if not self.live:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        if mask is None:
            mask = self.draw_mask(x.shape, generator, x.device)
        return torch.where(mask, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype, device=x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}, always_on={self.always_on}"


def live_dropout(model: nn.Module) -> bool:
    """Whether ``model``'s forward draws a dropout mask in its current mode."""
    return any(isinstance(m, Dropout) and m.live for m in model.modules())


class FourStageNet(nn.Module):
    """The forward and the defense hooks of the ResNets and PreActResNets:
    a stem (:meth:`stem`), four stages ``layer1``-``layer4``, an average pool
    of 4 and ``linear``.  :meth:`trunk` is the forward up to layer4's map and
    :meth:`head` the rest, so ``forward(x, channel_mask=m)`` is
    ``head(trunk(x), m)``: fine-pruning runs the trunk once and the head per
    mask.  The head pools before it masks, which equals masking before the
    pool for a 0/1 mask (each pooled value is a sum of its channel's
    elements); a (K, C) stack of masks gives (K, N, classes) logits."""

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def stages(self, x: torch.Tensor, feature_perturb: Optional[Dict[str, torch.Tensor]] = None):
        """Each stage's output by name, ``feature_perturb[name]`` added to it
        (Grad-CAM differentiates with respect to a zero perturbation)."""
        out = self.stem(x)
        feats = {}
        for stage in range(1, 5):
            name = f"layer{stage}"
            out = getattr(self, name)(out)
            if feature_perturb is not None and name in feature_perturb:
                out = out + feature_perturb[name]
            feats[name] = out
        return feats

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        return self.stages(x)["layer4"]

    def head(self, out: torch.Tensor, channel_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        pooled = avg_pool(out, 4)
        if channel_mask is not None:
            m = channel_mask.to(pooled.dtype)
            pooled = pooled * m[:, None, None] if m.dim() == 1 else pooled[None] * m[:, None, :, None, None]
        return self.linear(pooled.flatten(-3))

    def forward(
        self,
        x: torch.Tensor,
        channel_mask: Optional[torch.Tensor] = None,
        capture_features: bool = False,
        feature_perturb: Optional[Dict[str, torch.Tensor]] = None,
    ):
        feats = self.stages(x, feature_perturb)
        logits = self.head(feats["layer4"], channel_mask)
        return (logits, feats) if capture_features else logits
