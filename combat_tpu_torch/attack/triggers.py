"""Trigger synthesis and target mapping (the port of
``combat_tpu/attack/triggers.py``).

:func:`additive_trigger` is the core COMBAT trigger,
``gauss_smooth(clamp(x + low_freq(G(x)) * noise_rate, -1, 1))``.  With
``fused`` (the port's default, ``--pallas_trigger``) the whole chain is one
autograd function whose forward is kernel K1 and backward kernel K2, which
take the blur's taps and the truncated DCT matrix.  Without it the
low-pass runs on its own, followed by clamp and a depthwise blur: as kernel
K3 with ``lowfreq_kernel`` (``--pallas_lowfreq``), else as the ATen chain.
Every route takes any image size.

:func:`warp_trigger` is the WaNet warp: the (B, 2, s, s) flow field upsampled
to the image size, blended with the identity grid, clamped, grid-sampled.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.blur import draw_sigma, gaussian_blur, gaussian_kernel_1d
from ..ops.dct import low_freq
from ..ops.image import grid_sample, resize2d
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
    lowfreq_kernel: bool = False,
    sigma_draw: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Inject a generator noise map into the NCHW batch ``x``: DCT low-pass,
    scaled add, clamp, Gaussian blur with one sigma for the batch.
    ``sigma_draw`` is that sigma; absent, it is drawn from ``U(*sigma)``
    with ``generator``.  ``lowfreq_kernel`` picks K3 for the low-pass of the
    unfused chain; the fused chain ignores it, as the JAX package does."""
    if sigma_draw is None:
        sigma_draw = draw_sigma(sigma, generator, x.device)
    noise = noise.to(x.dtype)
    if fused:
        if not x.shape[-2] == x.shape[-1] == image_size:
            raise ValueError(f"the fused trigger takes square {image_size}px images, got {tuple(x.shape)}")
        taps = gaussian_kernel_1d(kernel_size, sigma_draw, x.dtype, x.device)
        return FusedTrigger.apply(x, noise, taps, truncated_dct(image_size, ratio, str(x.device)), noise_rate)
    n = low_freq(noise, image_size=image_size, ratio=ratio, use_kernel=lowfreq_kernel)
    x_bd = torch.clamp(x + n * noise_rate, -1.0, 1.0)
    return gaussian_blur(x_bd, sigma_draw, kernel_size)


def identity_grid(height: int, width: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The normalized (H, W, 2) identity sampling grid, (x, y) in the last
    axis, align_corners=True convention (reference
    ``train_generator_wanet.py:560-562``)."""
    ys = torch.linspace(-1.0, 1.0, height, dtype=dtype, device=device)
    xs = torch.linspace(-1.0, 1.0, width, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def warp_flow(flow: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The NCHW flow field (B, 2, s, s) upsampled to the image size (bicubic,
    align_corners=True) and permuted to the (B, H, W, 2) grid layout
    (reference ``train_generator_wanet.py:151-152``)."""
    return resize2d(flow, (height, width), method="bicubic", align_corners=True).permute(0, 2, 3, 1)


def warp_grid(flow_up: torch.Tensor, grid_rescale: float, clamp_grid: bool = True) -> torch.Tensor:
    """``identity * (1 - grid_rescale) + flow_up * grid_rescale``, clamped to
    [-1, 1]: the sampling grid of the warp.  The identity is float32 whatever
    the flow's dtype, and promotion gives the sum's, as in the JAX package:
    a bfloat16 flow does not round the grid to bfloat16."""
    h, w = flow_up.shape[1], flow_up.shape[2]
    grid = identity_grid(h, w, device=flow_up.device)[None] * (1.0 - grid_rescale) + flow_up * grid_rescale
    return torch.clamp(grid, -1.0, 1.0) if clamp_grid else grid


def warp_trigger(x: torch.Tensor, flow: torch.Tensor, *, grid_rescale: float, clamp_grid: bool = True) -> torch.Tensor:
    """WaNet-style warp of the NCHW batch ``x`` by the (B, 2, s, s) flow
    field (reference ``train_generator_wanet.py:151-157``)."""
    flow_up = warp_flow(flow, x.shape[-2], x.shape[-1])
    return grid_sample(x, warp_grid(flow_up, grid_rescale, clamp_grid), align_corners=True)
