"""Trigger synthesis and target mapping (the port of
``combat_tpu/attack/triggers.py``).

:func:`additive_trigger` is the core COMBAT trigger,
``gauss_smooth(clamp(x + low_freq(G(x)) * noise_rate, -1, 1))``.  With
``fused`` (the port's default, ``--pallas_trigger``) the whole chain is one
autograd function whose forward is kernel K1 and backward kernel K2, which
take the blur's taps and the truncated DCT matrix; without
it the low-pass runs as kernel K3, followed by clamp and a depthwise blur.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.blur import draw_sigma, gaussian_blur, gaussian_kernel_1d
from ..ops.dct import low_freq
from ..ops.trigger_kernels import FusedTrigger, truncated_dct


def create_targets_bd(targets: torch.Tensor, attack_mode: str, target_label: int, num_classes: int) -> torch.Tensor:
    if attack_mode == "all2one":
        return torch.full_like(targets, target_label)
    if attack_mode == "all2all":
        return (targets + 1) % num_classes
    raise ValueError(f"{attack_mode} attack mode is not implemented")


def additive_trigger(
    x: torch.Tensor,
    noise: torch.Tensor,
    *,
    image_size: int,
    ratio: float,
    noise_rate: float,
    kernel_size: int,
    sigma: Tuple[float, float],
    fused: bool = True,
    sigma_draw: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Inject a generator noise map into the NCHW batch ``x``: DCT low-pass,
    scaled add, clamp, Gaussian blur with one sigma for the batch.
    ``sigma_draw`` is that sigma; absent, it is drawn from ``U(*sigma)``
    with ``generator``."""
    if sigma_draw is None:
        sigma_draw = draw_sigma(sigma, generator, x.device)
    noise = noise.to(x.dtype)
    if fused:
        if not x.shape[-2] == x.shape[-1] == image_size:
            raise ValueError(f"the fused trigger takes square {image_size}px images, got {tuple(x.shape)}")
        taps = gaussian_kernel_1d(kernel_size, sigma_draw, x.dtype, x.device)
        return FusedTrigger.apply(x, noise, taps, truncated_dct(image_size, ratio, str(x.device)), noise_rate)
    n = low_freq(noise, image_size=image_size, ratio=ratio)
    x_bd = torch.clamp(x + n * noise_rate, -1.0, 1.0)
    return gaussian_blur(x_bd, sigma_draw, kernel_size)
