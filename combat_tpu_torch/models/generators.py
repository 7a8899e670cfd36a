"""Trigger generators (NCHW; the port of ``combat_tpu/models/generators.py``).

Reference ``networks/models.py``:
  * :class:`UnetGenerator` (``:268-341``): a 4-stage stride-2 conv encoder
    (nf..8nf, InstanceNorm, LeakyReLU 0.2) and a decoder of bilinear 2x
    upsampling (align_corners=False, as ``nn.Upsample``) + conv pairs with
    additive skips and a tanh output.  The reference's unused
    ``Dropout(0.3)`` is omitted, as in the JAX package.
  * :class:`UnetGeneratorBK` (``:194-265``): the same trunk, emitting
    ``clamp(tanh(.) * 0.08 + x, -1, 1)``.
  * :class:`GridGenerator` (``:344-385``): the encoder, global average
    pooling and a 2-layer MLP -> a (B, 2, s, s) tanh flow field (WaNet).
  * :class:`MixedGenerator` (``:388-469``): (flow, noise).
  * :class:`CUnetGenerator` (``CUnetGeneratorv1``, ``:472-555``): a one-hot
    label map concatenated to the conv0_0 features (class-conditional).
  * :class:`FixedTriggerGenerator` (``:620-627``): a learnable constant.

The flow field keeps the reference's NCHW (B, 2, s, s); the JAX package
permutes it to (B, s, s, 2).  In a ``--compute_dtype`` run (``layers.py``)
the convolutions and the flow head compute in that dtype, and the
activations, InstanceNorm's output and the upsampling stay in it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.image import upsample2x_bilinear
from .layers import Conv2d, Linear, instance_norm


def _conv(cin: int, cout: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, 3, stride, 1, bias=True)


def _act(x):
    return F.leaky_relu(x, negative_slope=0.2)


class UnetEncoder(nn.Module):
    """``cond_channels`` > 0: a (B, cond_channels, H/2, W/2) map joins the
    conv0_0 features, in their dtype, before conv0_1 (the class-conditional
    UNet)."""

    def __init__(self, in_channels: int = 3, nf: int = 64, cond_channels: int = 0):
        super().__init__()
        self.conv0_0 = _conv(in_channels, nf, 2)
        self.conv0_1 = _conv(nf + cond_channels, nf)
        self.conv1_0 = _conv(nf, nf * 2, 2)
        self.conv1_1 = _conv(nf * 2, nf * 2)
        self.conv2_0 = _conv(nf * 2, nf * 4, 2)
        self.conv2_1 = _conv(nf * 4, nf * 4)
        self.conv3_0 = _conv(nf * 4, nf * 8, 2)
        self.conv3_1 = _conv(nf * 8, nf * 8)

    def forward(self, x, cond=None):
        f0 = self.conv0_0(x)
        if cond is not None:
            f0 = torch.cat([f0, cond.to(f0.dtype)], dim=1)
        f0 = instance_norm(self.conv0_1(_act(f0)))
        f1 = instance_norm(self.conv1_0(_act(f0)))
        f1 = instance_norm(self.conv1_1(_act(f1)))
        f2 = instance_norm(self.conv2_0(_act(f1)))
        f2 = instance_norm(self.conv2_1(_act(f2)))
        f3 = instance_norm(self.conv3_0(_act(f2)))
        f3 = instance_norm(self.conv3_1(_act(f3)))
        return f0, f1, f2, f3


class UnetDecoder(nn.Module):
    def __init__(self, nf: int = 64, out_channels: int = 3):
        super().__init__()
        self.upconv3_1 = _conv(nf * 8, nf * 8)
        self.upconv3_0 = _conv(nf * 8, nf * 4)
        self.upconv2_1 = _conv(nf * 4, nf * 4)
        self.upconv2_0 = _conv(nf * 4, nf * 2)
        self.upconv1_1 = _conv(nf * 2, nf * 2)
        self.upconv1_0 = _conv(nf * 2, nf)
        self.upconv0_1 = _conv(nf, nf)
        self.upconv0_0 = _conv(nf, out_channels)

    def forward(self, f0, f1, f2, f3):
        u3 = instance_norm(self.upconv3_1(_act(upsample2x_bilinear(f3))))
        u3 = instance_norm(self.upconv3_0(_act(u3))) + f2
        u2 = instance_norm(self.upconv2_1(_act(upsample2x_bilinear(u3))))
        u2 = instance_norm(self.upconv2_0(_act(u2))) + f1
        u1 = instance_norm(self.upconv1_1(_act(upsample2x_bilinear(u2))))
        u1 = instance_norm(self.upconv1_0(_act(u1))) + f0
        u0 = instance_norm(self.upconv0_1(_act(upsample2x_bilinear(u1))))
        return torch.tanh(self.upconv0_0(_act(u0)))


class UnetGenerator(nn.Module):
    def __init__(self, in_channels: int = 3, nf: int = 64, out_channels: int = 3):
        super().__init__()
        self.enc = UnetEncoder(in_channels, nf)
        self.dec = UnetDecoder(nf, out_channels)

    def forward(self, x):
        return self.dec(*self.enc(x))


class UnetGeneratorBK(nn.Module):
    """Emits the triggered image ``clamp(tanh(.) * 0.08 + x, -1, 1)``
    (reference ``models.py:264``)."""

    def __init__(self, in_channels: int = 3, nf: int = 64):
        super().__init__()
        self.enc = UnetEncoder(in_channels, nf)
        self.dec = UnetDecoder(nf, in_channels)

    def forward(self, x):
        return torch.clamp(self.dec(*self.enc(x)) * 0.08 + x, -1.0, 1.0)


class _FlowHead(nn.Module):
    """Global average pool of the deepest features, fc1, LeakyReLU, fc2 ->
    a (B, 2, s, s) tanh flow field."""

    def __init__(self, s: int, nf: int):
        super().__init__()
        self.s = s
        self.fc1 = Linear(nf * 8, nf)
        self.fc2 = Linear(nf, s * s * 2)

    def forward(self, f3):
        f = self.fc2(_act(self.fc1(f3.mean(dim=(2, 3)))))
        return torch.tanh(f.view(-1, 2, self.s, self.s))


class GridGenerator(nn.Module):
    """WaNet flow-field generator -> (B, 2, s, s) in [-1, 1]."""

    def __init__(self, in_channels: int = 3, s: int = 2, nf: int = 64):
        super().__init__()
        self.enc = UnetEncoder(in_channels, nf)
        self.head = _FlowHead(s, nf)

    def forward(self, x):
        return self.head(self.enc(x)[3])


class MixedGenerator(nn.Module):
    """Returns (flow (B, 2, s, s), noise (B, C, H, W))."""

    def __init__(self, in_channels: int = 3, s: int = 2, nf: int = 64, out_channels: int = 3):
        super().__init__()
        self.enc = UnetEncoder(in_channels, nf)
        self.dec = UnetDecoder(nf, out_channels)
        self.head = _FlowHead(s, nf)

    def forward(self, x):
        f0, f1, f2, f3 = self.enc(x)
        return self.head(f3), self.dec(f0, f1, f2, f3)


class CUnetGenerator(nn.Module):
    """Class-conditional UNet: G(x, y) with the one-hot label map of ``y``
    concatenated to the conv0_0 features (reference ``models.py:523-530``)."""

    def __init__(self, in_channels: int = 3, num_classes: int = 10, nf: int = 64, out_channels: int = 3):
        super().__init__()
        self.num_classes = num_classes
        self.enc = UnetEncoder(in_channels, nf, cond_channels=num_classes)
        self.dec = UnetDecoder(nf, out_channels)

    def forward(self, x, y):
        h, w = (x.shape[-2] + 1) // 2, (x.shape[-1] + 1) // 2  # conv0_0's stride-2 output
        y_map = F.one_hot(y.long(), self.num_classes)[:, :, None, None]  # the encoder casts it to f0's dtype
        return self.dec(*self.enc(x, y_map.expand(-1, -1, h, w)))


class FixedTriggerGenerator(nn.Module):
    """A learnable constant (C, H, W) trigger, init U(-1, 1) (reference
    ``models.py:620-627``), broadcast over the batch."""

    def __init__(self, height: int = 32, width: int = 32, channels: int = 3):
        super().__init__()
        self.trigger = nn.Parameter(torch.empty(channels, height, width).uniform_(-1.0, 1.0))

    def forward(self, x):
        return self.trigger[None].expand(x.shape[0], -1, -1, -1)
