"""Orthonormal 2-D DCT as matmuls, the trigger low-pass and the detector's
featurization (NCHW; the port of ``combat_tpu/ops/dct.py``).

``dct_2d``/``idct_2d`` transform the last two axes: Y = D X D^T and
X = D^T Y D with D the orthonormal DCT-II matrix, kept on the device once
per (size, dtype, device).  :func:`low_freq` is the trigger low-pass: with
``use_kernel`` (``--pallas_lowfreq``) it runs as kernel K3 on a CUDA tensor
(``ops/trigger_kernels.py``), else as the ATen chain of the JAX package's
XLA path; on a CPU tensor both compute the plain result.
"""

from __future__ import annotations

import functools

import torch

from .trigger_kernels import LowFreq, _dct_matrix_np, trigger_operands


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The (n, n) DCT-II matrix, made once per (n, dtype, device) and shared
    by every caller: do not write to it."""
    return torch.tensor(_dct_matrix_np(n), dtype=dtype, device=device)


def dct_2d(x: torch.Tensor) -> torch.Tensor:
    """2-D orthonormal DCT-II over the last two axes (H, W)."""
    dh = dct_matrix(x.shape[-2], x.dtype, x.device)
    dw = dct_matrix(x.shape[-1], x.dtype, x.device)
    return dh @ x @ dw.T


def idct_2d(y: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`dct_2d` (orthonormal DCT-III)."""
    dh = dct_matrix(y.shape[-2], y.dtype, y.device)
    dw = dct_matrix(y.shape[-1], y.dtype, y.device)
    return dh.T @ y @ dw


def low_freq(x: torch.Tensor, image_size: int, ratio: float, use_kernel: bool = False) -> torch.Tensor:
    """DCT low-pass of a [-1, 1] NCHW batch: keeps the top-left
    ``int(image_size * ratio)`` square of DCT-II coefficients of the
    [0, 255]-scaled image and maps back to [-1, 1].  Differentiable.

    ``use_kernel`` launches kernel K3 (forward and backward) for a CUDA
    tensor, at any H (the tiled K3 above 64 px); without it the low-pass is
    ``dct_2d``, the corner mask and ``idct_2d``.  A
    cutoff of 0 keeps nothing: -1 everywhere with a zero gradient, on either
    route and without a kernel, as the JAX package gives."""
    h, w = x.shape[-2], x.shape[-1]
    if not h == w == image_size:
        raise ValueError(f"low_freq takes square {image_size}px images, got {h}x{w}")
    if int(image_size * ratio) < 1:
        return x * 0.0 - 1.0
    if use_kernel:
        return LowFreq.apply(x, ratio)
    _, mask = trigger_operands(h, ratio, str(x.device))
    y = dct_2d((x + 1.0) * 0.5 * 255.0) * mask.to(x.dtype)
    return idct_2d(y) / 255.0 * 2.0 - 1.0


def detector_features(x_bd: torch.Tensor) -> torch.Tensor:
    """Frequency-detector input: DCT of the uint8-truncated image, as the
    reference's ``dct_2d(((inputs_bd + 1) / 2 * 255).byte())``.  Used on the
    metric path only, so it carries no gradient."""
    q = torch.trunc((x_bd.detach() + 1.0) * 0.5 * 255.0).to(torch.uint8)
    return dct_2d(q.to(x_bd.dtype))
