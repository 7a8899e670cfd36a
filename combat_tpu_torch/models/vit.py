"""Vision transformers (the port of ``combat_tpu/models/vit.py``).

:class:`SimpleViT` is ``vit_pytorch.SimpleViT`` as the JAX package builds it
(``--model vit``: patch 4, dim 768, depth 6, heads 8, mlp 1024;
``simplevitsmall8``: patch 8, dim 384, depth 12, heads 6, mlp 1536): patches
flattened in ``(p1 p2 c)`` order from the NHWC image, LayerNorm-Linear-
LayerNorm embedding, the fixed 2-D sin-cos position embedding, pre-norm
attention and feed-forward blocks (tanh-approximated GELU, Flax's
``nn.gelu`` default), mean pool, linear head.  :class:`VisionTransformer`
is timm's ``vit_small`` geometry (``--model vitsmall``): a conv patch
embedding, a CLS token, a learned position embedding, pre-norm blocks with
exact GELU, the CLS token's head.

As in the JAX package, attention is a plain product and softmax, the
LayerNorms take Flax's epsilon 1e-6, and no layer computes in
``--compute_dtype``: the ViTs are built of ``torch.nn``'s own layers, which
``layers.set_compute_dtype`` leaves in float32.  A fresh model draws Flax's
default init: lecun-normal kernels, zero biases, ``pos_embed`` N(0, 0.02),
a zero CLS token.  Module names follow the JAX model.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import LayerNorm


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """Flax's default kernel init, ``lecun_normal``: a normal truncated at two
    standard deviations, scaled so that its variance is 1 / fan_in."""
    fan_in = weight[0].numel()  # (out, in, *kernel) or (out, in)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


def posemb_sincos_2d(h: int, w: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
    """The fixed 2-D sin-cos position embedding, (h * w, dim) float32."""
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    if dim % 4:
        raise ValueError("feature dim must be a multiple of 4 for 2d sin-cos posemb")
    omega = np.arange(dim // 4) / (dim // 4 - 1)
    omega = 1.0 / (temperature**omega)
    y = y.flatten()[:, None] * omega[None, :]
    x = x.flatten()[:, None] * omega[None, :]
    return np.concatenate([np.sin(x), np.cos(x), np.sin(y), np.cos(y)], axis=1).astype(np.float32)


def _dense(fan_in: int, features: int, bias: bool = True) -> nn.Linear:
    layer = nn.Linear(fan_in, features, bias=bias)
    lecun_normal_(layer.weight)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Multi-head attention of (b, n, heads * d) projections, plain softmax."""
    b, n, inner = q.shape
    d = inner // heads
    q, k, v = (t.reshape(b, n, heads, d).transpose(1, 2) for t in (q, k, v))
    attn = torch.softmax(q @ k.transpose(-1, -2) * (d**-0.5), dim=-1)
    return (attn @ v).transpose(1, 2).reshape(b, n, inner)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int = 64):
        super().__init__()
        self.heads = heads
        inner = heads * dim_head
        self.norm = LayerNorm(dim)
        self.to_qkv = _dense(dim, inner * 3, bias=False)
        self.to_out = _dense(inner, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.to_qkv(self.norm(x)).chunk(3, dim=-1)
        return self.to_out(_attend(q, k, v, self.heads))


class FeedForward(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fc1 = _dense(dim, mlp_dim)
        self.fc2 = _dense(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(self.norm(x)), approximate="tanh"))


class SimpleViT(nn.Module):
    def __init__(
        self,
        image_size: int = 32,
        patch_size: int = 4,
        num_classes: int = 10,
        dim: int = 768,
        depth: int = 6,
        heads: int = 8,
        mlp_dim: int = 1024,
        dim_head: int = 64,
        in_channels: int = 3,
    ):
        super().__init__()
        self.patch_size, self.depth = patch_size, depth
        patch_dim = patch_size * patch_size * in_channels
        self.patch_norm1 = LayerNorm(patch_dim)
        self.patch_embed = _dense(patch_dim, dim)
        self.patch_norm2 = LayerNorm(dim)
        g = image_size // patch_size
        self.register_buffer("pos_embedding", torch.from_numpy(posemb_sincos_2d(g, g, dim)), persistent=False)
        for i in range(depth):
            setattr(self, f"attn{i}", Attention(dim, heads, dim_head))
            setattr(self, f"ff{i}", FeedForward(dim, mlp_dim))
        self.final_norm = LayerNorm(dim)
        self.head = _dense(dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        p = self.patch_size
        # b c (gh p) (gw p) -> b (gh gw) (p p c), the JAX package's NHWC order
        x = x.permute(0, 2, 3, 1).reshape(n, h // p, p, w // p, p, c).transpose(2, 3).reshape(n, -1, p * p * c)
        x = self.patch_norm2(self.patch_embed(self.patch_norm1(x))) + self.pos_embedding
        for i in range(self.depth):
            x = x + getattr(self, f"attn{i}")(x)
            x = x + getattr(self, f"ff{i}")(x)
        return self.head(self.final_norm(x).mean(dim=1))


class TimmBlock(nn.Module):
    """Pre-norm transformer block with timm's parameterization (qkv bias,
    projection bias, exact-GELU MLP)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(dim)
        self.qkv = _dense(dim, dim * 3)
        self.proj = _dense(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.fc1 = _dense(dim, int(dim * mlp_ratio))
        self.fc2 = _dense(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(self.norm1(x)).chunk(3, dim=-1)
        x = x + self.proj(_attend(q, k, v, self.heads))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class VisionTransformer(nn.Module):
    def __init__(
        self,
        image_size: int = 32,
        patch_size: int = 2,
        num_classes: int = 10,
        dim: int = 384,
        depth: int = 12,
        heads: int = 6,
        mlp_ratio: float = 4.0,
        in_channels: int = 3,
    ):
        super().__init__()
        self.depth = depth
        self.patch_embed = nn.Conv2d(in_channels, dim, patch_size, patch_size)
        lecun_normal_(self.patch_embed.weight)
        nn.init.zeros_(self.patch_embed.bias)
        tokens = (image_size // patch_size) ** 2 + 1
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.randn(1, tokens, dim) * 0.02)
        for i in range(depth):
            setattr(self, f"block{i}", TimmBlock(dim, heads, mlp_ratio))
        self.final_norm = LayerNorm(dim)
        self.head = _dense(dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # (n, tokens, dim), row-major as NHWC's reshape
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1) + self.pos_embed
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.head(self.final_norm(x)[:, 0])


def vit(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> SimpleViT:
    return SimpleViT(input_size, 4, num_classes, dim=768, depth=6, heads=8, mlp_dim=1024, in_channels=in_channels)


def simplevitsmall8(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> SimpleViT:
    return SimpleViT(input_size, 8, num_classes, dim=384, depth=12, heads=6, mlp_dim=384 * 4, in_channels=in_channels)


def vitsmall(num_classes: int = 10, input_size: int = 32, in_channels: int = 3) -> VisionTransformer:
    """timm's ViT-S/16 geometry with the patch scaled to the image,
    ``max(1, input_size // 16)`` (reference ``eval.py:24-40``)."""
    return VisionTransformer(input_size, max(1, input_size // 16), num_classes, dim=384, depth=12, heads=6,
                             in_channels=in_channels)
