"""Model factories of this slice of the port (``combat_tpu/models/registry.py``).

Ported so far: the PreActResNet18 classifier (the default of cifar10 and
gtsrb), ResNet18 (the default of celeba and imagenet10), ``--model``
``preactresnet18``, ``resnet18`` and ``resnet34`` for any dataset, every
trigger generator and the ``original`` frequency detector.  Any other name
raises ``NotImplementedError`` naming the later slice that ports it.

Every model is built in ``cfg.compute_dtype`` (``layers.py``), the frozen
clean model and the detector too, as every module of the JAX package reads
its compute dtype.
"""

from __future__ import annotations

import torch.nn as nn

from ..config import Config
from .frequency import FrequencyModel
from .generators import (
    CUnetGenerator,
    FixedTriggerGenerator,
    GridGenerator,
    MixedGenerator,
    UnetGenerator,
    UnetGeneratorBK,
)
from .layers import parse_compute_dtype, set_compute_dtype
from .preact_resnet import preact_resnet18
from .resnet import resnet18, resnet34

_LATER = "is not ported yet: the other classifiers, generators and detectors are a later slice of the port"

# --model names ported so far (the JAX registry's CLASSIFIERS), and each
# dataset's default (combat_tpu/models/registry.py::get_classifier)
_CLASSIFIERS = {"preactresnet18": preact_resnet18, "resnet18": resnet18, "resnet34": resnet34}
_DEFAULTS = {"cifar10": "preactresnet18", "gtsrb": "preactresnet18", "celeba": "resnet18", "imagenet10": "resnet18"}


def get_classifier(cfg: Config) -> nn.Module:
    """Default classifier per dataset; a named model is built for any
    dataset, as in the JAX registry."""
    if cfg.model == "default" and cfg.dataset not in _DEFAULTS:
        raise NotImplementedError(f"the default classifier of dataset {cfg.dataset!r} {_LATER}")
    name = _DEFAULTS[cfg.dataset] if cfg.model == "default" else cfg.model
    if name not in _CLASSIFIERS:
        raise NotImplementedError(f"classifier {cfg.model!r} {_LATER}")
    return _in_dtype(cfg, _CLASSIFIERS[name](cfg.num_classes, cfg.input_height, cfg.input_channel))


def get_generator(cfg: Config, kind: str = "unet") -> nn.Module:
    c = cfg.input_channel
    if kind == "unet":
        return _in_dtype(cfg, UnetGenerator(in_channels=c, out_channels=c))
    if kind == "unet_bk":
        return _in_dtype(cfg, UnetGeneratorBK(in_channels=c))
    if kind == "grid":
        return _in_dtype(cfg, GridGenerator(in_channels=c, s=cfg.s))
    if kind == "mixed":
        return _in_dtype(cfg, MixedGenerator(in_channels=c, s=cfg.s, out_channels=c))
    if kind == "cunet":
        return _in_dtype(cfg, CUnetGenerator(in_channels=c, num_classes=cfg.num_classes, out_channels=c))
    if kind == "fixed":  # a parameter, no convolution: float32 in either dtype, as in the JAX package
        return FixedTriggerGenerator(cfg.input_height, cfg.input_width, c)
    raise ValueError(f"unknown generator kind {kind!r}")


def get_frequency_detector(cfg: Config) -> nn.Module:
    if cfg.F_model in ("original", "original_holdout"):
        return _in_dtype(cfg, FrequencyModel(num_classes=2, input_size=cfg.input_height, in_channels=cfg.input_channel))
    raise NotImplementedError(f"frequency detector {cfg.F_model!r} {_LATER}")


def _in_dtype(cfg: Config, model: nn.Module) -> nn.Module:
    return set_compute_dtype(model, parse_compute_dtype(cfg.compute_dtype))
