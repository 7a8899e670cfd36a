"""Train-time augmentation (NCHW; the port of ``combat_tpu/ops/augment.py``).

The reference's ``PostTensorTransform``: kornia ``RandomCrop(p=0.8,
padding=5)``, ``RandomRotation(10, p=0.5)`` and ``RandomHorizontalFlip``.
The crop and rotation gates are drawn once per batch, offsets, angles and
flips once per image.  Crop, rotation and flip compose into one bilinear
resample from the zero-padded image, with the interpolation taps masked to
each image's crop window so the rotation's zero fill is relative to the crop,
exactly as in the JAX package.

The resample contracts a rank-5 intermediate of n*c*h*w*(h+2*pad) values:
66 MB at 32 px and bs 128, 4.5 GB at 224 px and bs 32.  Above
``_CHUNK_BYTES`` it runs over blocks of output rows, the smallest number of
blocks that divides H and keeps each under the budget (28 blocks of 8 rows
at 224 px, bs 32), with the same values; the JAX package chunks alike.

Every draw can be passed in as :class:`AugDraws`; absent, they come from the
given ``torch.Generator`` (:func:`draw_augment`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

# Device-memory budget of the resample's rank-5 intermediate; above it the
# output rows are resampled in blocks (combat_tpu/ops/augment.py:36).
_CHUNK_BYTES = 256 * 1024 * 1024


class AugDraws(NamedTuple):
    crop_gate: torch.Tensor  # () bool, p = 0.8
    tops: torch.Tensor  # (n,) int64 in [0, 2*pad]
    lefts: torch.Tensor  # (n,) int64 in [0, 2*pad]
    rot_gate: torch.Tensor  # () bool, p = 0.5
    angles: torch.Tensor  # (n,) degrees in [-max, max)
    flips: torch.Tensor  # (n,) bool, p = 0.5


def draw_augment(
    n: int, generator: Optional[torch.Generator], device, crop_padding: int, rotation_degrees: float
) -> AugDraws:
    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def offsets():
        return torch.randint(0, 2 * crop_padding + 1, (n,), generator=generator, device=device)

    return AugDraws(
        crop_gate=rand() < 0.8,
        tops=offsets(),
        lefts=offsets(),
        rot_gate=rand() < 0.5,
        angles=(rand(n) * 2.0 - 1.0) * rotation_degrees,
        flips=rand(n) < 0.5,
    )


def post_tensor_transform(
    x: torch.Tensor,
    draws: Optional[AugDraws] = None,
    *,
    generator: Optional[torch.Generator] = None,
    crop_padding: int = 5,
    rotation_degrees: float = 10.0,
    hflip: bool = True,
    option: str = "use",
) -> torch.Tensor:
    """The train-time augmentation stack.  ``option`` mirrors
    ``--post_transform_option``: "use" (crop+rotation+flip), "use_modified"
    (no crop), "no_use" (identity)."""
    if option == "no_use":
        return x
    n, _, h, w = x.shape
    pad = crop_padding
    if draws is None:
        draws = draw_augment(n, generator, x.device, pad, rotation_degrees)
    dtype = x.dtype
    padded = F.pad(x, (pad, pad, pad, pad))

    crop_gate = draws.crop_gate & (option != "use_modified")
    tops = torch.where(crop_gate, draws.tops, pad)
    lefts = torch.where(crop_gate, draws.lefts, pad)

    angles = torch.where(draws.rot_gate, draws.angles.to(dtype), 0.0)
    theta = angles * (math.pi / 180.0)
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    ys = torch.linspace(-1.0, 1.0, h, dtype=dtype, device=x.device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=dtype, device=x.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    # crop-frame pixel coords of the rotated sampling grid (align_corners)
    fx = (cos * gx + sin * gy + 1.0) * 0.5 * (w - 1)
    fy = (-sin * gx + cos * gy + 1.0) * 0.5 * (h - 1)
    if hflip:
        flip = draws.flips[:, None, None]
        fx = torch.where(flip, fx.flip(-1), fx)
        fy = torch.where(flip, fy.flip(-1), fy)

    fxp = fx + lefts[:, None, None].to(dtype)
    fyp = fy + tops[:, None, None].to(dtype)
    src_y = torch.arange(h + 2 * pad, dtype=dtype, device=x.device)
    src_x = torch.arange(w + 2 * pad, dtype=dtype, device=x.device)

    def taps(f, lo, size, src):
        """Bilinear weights of the (n, rows, w) coordinates ``f`` on the
        source axis ``src``, masked to each image's crop window [lo, lo +
        size - 1]: the rotation's zero fill is relative to the crop."""
        u = (1.0 - (f[..., None] - src).abs()).clamp_min(0.0)  # (n, rows, w, S)
        m = (src[None, :] >= lo[:, None]) & (src[None, :] <= lo[:, None] + (size - 1))
        return u * m[:, None, None, :].to(dtype)

    def resample(rows: slice) -> torch.Tensor:
        ux = taps(fxp[:, rows], lefts, w, src_x)
        uy = taps(fyp[:, rows], tops, h, src_y)
        t = torch.einsum("bijx,bcyx->bcijy", ux, padded)
        return torch.einsum("bijy,bcijy->bcij", uy, t)

    inter_bytes = n * x.shape[1] * h * w * (h + 2 * pad) * x.element_size()
    if inter_bytes <= _CHUNK_BYTES:
        return resample(slice(None))
    want = min(h, -(-inter_bytes // _CHUNK_BYTES))  # the fewest blocks, at most one row each
    blk = h // next(b for b in range(want, h + 1) if h % b == 0)
    return torch.cat([resample(slice(i, i + blk)) for i in range(0, h, blk)], dim=2)
