"""Numerics / transform ops (PyTorch, NCHW, explicit generators)."""

from .augment import AugDraws, draw_augment, post_tensor_transform
from .blur import blur_matrix, draw_sigma, gaussian_blur, gaussian_kernel_1d
from .dct import dct_2d, dct_matrix, detector_features, idct_2d, low_freq
from .image import grid_sample, resize2d, total_variation, upsample2x_bilinear

__all__ = [
    "AugDraws",
    "draw_augment",
    "post_tensor_transform",
    "blur_matrix",
    "draw_sigma",
    "gaussian_blur",
    "gaussian_kernel_1d",
    "dct_2d",
    "dct_matrix",
    "grid_sample",
    "detector_features",
    "idct_2d",
    "low_freq",
    "resize2d",
    "total_variation",
    "upsample2x_bilinear",
]
