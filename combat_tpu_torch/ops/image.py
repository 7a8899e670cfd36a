"""Image resampling ops: matrix-form resize, grid sample, total variation
(NCHW; the port of ``combat_tpu/ops/image.py``).

Every resize the pipeline needs is a static 1-D -> 1-D linear map applied
separably to H and W, so :func:`resize2d` builds the dense (out, in)
interpolation matrix once per (size, method) in numpy and applies it as two
products.  This covers the WaNet flow upsample (bicubic, align_corners=True;
reference ``train_generator_wanet.py:151-152``).

:func:`grid_sample` is ``F.grid_sample`` in the mode the WaNet warp uses
(bilinear, zero padding, align_corners=True).  The JAX package writes it as
two products of hat functions, outside any Pallas kernel; the ATen call is
its counterpart here.  Both give the same values; their gradients in the grid
differ only where a sample sits exactly on a pixel centre (torch's backward
is floor-based, the hat form's subgradient is balanced there).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _cubic_weight(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic kernel with torch's a = -0.75."""
    t = np.abs(t)
    w = np.zeros_like(t)
    m1 = t <= 1.0
    m2 = (t > 1.0) & (t < 2.0)
    w[m1] = ((a + 2.0) * t[m1] - (a + 3.0)) * t[m1] * t[m1] + 1.0
    w[m2] = (((t[m2] - 5.0) * t[m2] + 8.0) * t[m2] - 4.0) * a
    return w


@functools.lru_cache(maxsize=None)
def _resize_matrix_np(n_in: int, n_out: int, method: str, align_corners: bool) -> np.ndarray:
    """Dense (n_out, n_in) interpolation matrix; tap indices are clamped to
    the valid range, as torch handles the border for bilinear and bicubic."""
    if n_out == n_in and method in ("bilinear", "nearest"):
        return np.eye(n_in)
    dst = np.arange(n_out, dtype=np.float64)
    if align_corners:
        src = dst * (max(n_in - 1, 1) / max(n_out - 1, 1)) if n_out > 1 else np.zeros_like(dst)
    else:
        src = (dst + 0.5) * (n_in / n_out) - 0.5
    mat = np.zeros((n_out, n_in), dtype=np.float64)
    if method == "nearest":
        idx = np.clip(np.floor(src), 0, n_in - 1).astype(int)
        mat[np.arange(n_out), idx] = 1.0
    elif method == "bilinear":
        i0 = np.floor(src).astype(int)
        frac = src - i0
        for off, w in ((0, 1.0 - frac), (1, frac)):
            np.add.at(mat, (np.arange(n_out), np.clip(i0 + off, 0, n_in - 1)), w)
    elif method == "bicubic":
        i0 = np.floor(src).astype(int)
        frac = src - i0
        for off in (-1, 0, 1, 2):
            np.add.at(mat, (np.arange(n_out), np.clip(i0 + off, 0, n_in - 1)), _cubic_weight(frac - off))
    else:
        raise ValueError(f"unknown resize method {method!r}")
    return mat


@functools.lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int, method: str, align_corners: bool, dtype=torch.float32, device=None):
    """The (n_out, n_in) matrix on the device, made once per key and shared
    by every caller: do not write to it."""
    return torch.tensor(_resize_matrix_np(n_in, n_out, method, align_corners), dtype=dtype, device=device)


def resize2d(x: torch.Tensor, out_hw, method: str = "bilinear", align_corners: bool = False) -> torch.Tensor:
    """Separable resize of the last two axes (H, W) to ``out_hw``: two
    products with the interpolation matrices."""
    h_out, w_out = out_hw
    mh = resize_matrix(x.shape[-2], h_out, method, align_corners, x.dtype, x.device)
    mw = resize_matrix(x.shape[-1], w_out, method, align_corners, x.dtype, x.device)
    return mh @ x @ mw.T


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """``nn.Upsample(scale_factor=2, mode='bilinear')`` (align_corners=False),
    the UNet decoders' upsampling (reference ``networks/models.py:274``)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def grid_sample(x: torch.Tensor, grid: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """Bilinear sample of the NCHW batch ``x`` at ``grid`` (N, Ho, Wo, 2),
    (x, y) in [-1, 1], zeros outside."""
    return F.grid_sample(x, grid.to(x.dtype), mode="bilinear", padding_mode="zeros", align_corners=align_corners)


def total_variation(x: torch.Tensor) -> torch.Tensor:
    """Per-sample anisotropic total variation of an NCHW batch, shape (N,)
    (``kornia.losses.total_variation``, reference
    ``train_generator_imperceptible.py:228``)."""
    dh = (x[:, :, 1:, :] - x[:, :, :-1, :]).abs()
    dw = (x[:, :, :, 1:] - x[:, :, :, :-1]).abs()
    return dh.sum(dim=(1, 2, 3)) + dw.sum(dim=(1, 2, 3))
