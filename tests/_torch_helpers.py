"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Data crosses between JAX and PyTorch only as numpy arrays.  JAX keeps NHWC,
the port NCHW; the layout changes here, once, at the boundary.  Random draws
are not reproduced by the port's generator: the helpers recreate the JAX
step's own draws from its key and hand them to the port.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from combat_tpu_torch.ops.augment import AugDraws
from combat_tpu_torch.train.steps import AlternatedDraws
from combat_tpu_torch.train.variants import InputawareDraws, PairSigmas, WanetDraws


def nchw(a) -> torch.Tensor:
    """NHWC JAX/numpy array -> NCHW float32 torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().transpose(0, 2, 3, 1)


def jax_aug_draws(key, n: int, pad: int = 5, deg: float = 10.0) -> AugDraws:
    """The draws ``combat_tpu.ops.augment.post_tensor_transform`` makes from
    ``key`` (augment.py:120-134)."""
    k_cgate, k_crop, k_rgate, k_rot, k_flip = jax.random.split(key, 5)
    kt, kl = jax.random.split(k_crop)

    def t(a, dtype=None):
        return torch.from_numpy(np.array(a, dtype=dtype))

    return AugDraws(
        crop_gate=t(jax.random.bernoulli(k_cgate, 0.8)),
        tops=t(jax.random.randint(kt, (n,), 0, 2 * pad + 1), np.int64),
        lefts=t(jax.random.randint(kl, (n,), 0, 2 * pad + 1), np.int64),
        rot_gate=t(jax.random.bernoulli(k_rgate, 0.5)),
        angles=t(jax.random.uniform(k_rot, (n,), minval=-deg, maxval=deg), np.float32),
        flips=t(jax.random.bernoulli(k_flip, 0.5, (n,))),
    )


def jax_sigma(key, sigma_range) -> torch.Tensor:
    """The blur sigma ``random_gaussian_blur`` / the fused trigger draw from
    ``key`` (blur.py:44-49, triggers.py:58-59)."""
    lo, hi = sigma_range
    return torch.tensor(float(jax.random.uniform(key, (), minval=lo, maxval=hi)))


def jax_alternated_draws(key, cfg, n: int) -> AlternatedDraws:
    """The draws of ``make_alternated_train_step`` from its step key
    (steps.py:133,150: ``k = split(key, 10)``)."""
    k = jax.random.split(key, 10)
    aug = lambda kk: jax_aug_draws(kk, n, cfg.random_crop, float(cfg.random_rotation))  # noqa: E731
    return AlternatedDraws(
        sigma_c=jax_sigma(k[0], cfg.sigma),
        poison=torch.from_numpy(np.array(jax.random.bernoulli(k[1], cfg.pc, (n,)))),
        aug_c=aug(k[2]),
        aug_cm=aug(k[3]),
        sigma_g=jax_sigma(k[4], cfg.sigma),
        aug_g=aug(k[5]),
        aug_g_cm=aug(k[6]),
        aug_clean=aug(k[7]),
    )


def jax_wanet_draws(key, cfg, n: int) -> WanetDraws:
    """The draws of ``make_wanet_train_step`` (variants.py: ``k = split(key,
    8)``; ``k[0]`` the poison gate, ``k[1..5]`` the augmentations)."""
    k = jax.random.split(key, 8)
    aug = lambda kk: jax_aug_draws(kk, n, cfg.random_crop, float(cfg.random_rotation))  # noqa: E731
    return WanetDraws(
        poison=torch.from_numpy(np.array(jax.random.bernoulli(k[0], cfg.pc, (n,)))),
        aug_c=aug(k[1]), aug_cm=aug(k[2]), aug_g=aug(k[3]), aug_g_cm=aug(k[4]), aug_clean=aug(k[5]),
    )


def jax_inputaware_draws(key, cfg, n: int) -> InputawareDraws:
    """The draws of ``make_inputaware_train_step`` (variants.py: ``k =
    split(key, 10)``; ``k[4]``, ``k[5]`` the two G-step sigmas, ``k[6..8]``
    the G-step augmentations, ``k[9]`` the clean metric)."""
    k = jax.random.split(key, 10)
    aug = lambda kk: jax_aug_draws(kk, n, cfg.random_crop, float(cfg.random_rotation))  # noqa: E731
    return InputawareDraws(
        sigma_c=jax_sigma(k[0], cfg.sigma),
        poison=torch.from_numpy(np.array(jax.random.bernoulli(k[1], cfg.pc, (n,)))),
        aug_c=aug(k[2]),
        aug_cm=aug(k[3]),
        sigma_g=jax_sigma(k[4], cfg.sigma),
        sigma_cross=jax_sigma(k[5], cfg.sigma),
        aug_g=aug(k[6]),
        aug_cross=aug(k[7]),
        aug_g_cm=aug(k[8]),
        aug_clean=aug(k[9]),
    )


def jax_pair_sigmas(key, cfg, n: int) -> PairSigmas:
    """The sigmas of the input-aware eval steps (``k = split(key, n)``, n 3
    in the attack eval and 2 in the victim eval; the trigger of G(x) takes
    ``k[0]``, the cross trigger ``k[1]``)."""
    k = jax.random.split(key, n)
    return PairSigmas(jax_sigma(k[0], cfg.sigma), jax_sigma(k[1], cfg.sigma))


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_state_close(port_sd, jax_sd, atol, rtol=0.0, skip=("num_batches_tracked",)):
    """Every entry of the converted JAX ``state_dict`` against the port's."""
    assert set(jax_sd) <= set(port_sd), sorted(set(jax_sd) - set(port_sd))
    for k, v in jax_sd.items():
        if k.endswith(skip):
            continue
        np.testing.assert_allclose(port_sd[k].detach().cpu().numpy(), v.numpy(), atol=atol, rtol=rtol, err_msg=k)
