"""Model factories of this slice of the port (``combat_tpu/models/registry.py``).

Ported so far: the PreActResNet18 classifier (the default of cifar10 and
gtsrb, and any dataset's with ``--model preactresnet18``), every trigger
generator and the ``original`` frequency detector.  Any other name raises
``NotImplementedError`` naming the later slice that ports it.
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
from .preact_resnet import preact_resnet18

_LATER = "is not ported yet: the other classifiers, generators and detectors are a later slice of the port"


def get_classifier(cfg: Config) -> nn.Module:
    """Default classifier per dataset; a named model is built for any
    dataset, as in the JAX registry."""
    if cfg.model == "default" and cfg.dataset not in ("cifar10", "gtsrb"):
        raise NotImplementedError(f"the default classifier of dataset {cfg.dataset!r} {_LATER}")
    if cfg.model not in ("default", "preactresnet18"):
        raise NotImplementedError(f"classifier {cfg.model!r} {_LATER}")
    return preact_resnet18(cfg.num_classes, cfg.input_height, cfg.input_channel)


def get_generator(cfg: Config, kind: str = "unet") -> nn.Module:
    c = cfg.input_channel
    if kind == "unet":
        return UnetGenerator(in_channels=c, out_channels=c)
    if kind == "unet_bk":
        return UnetGeneratorBK(in_channels=c)
    if kind == "grid":
        return GridGenerator(in_channels=c, s=cfg.s)
    if kind == "mixed":
        return MixedGenerator(in_channels=c, s=cfg.s, out_channels=c)
    if kind == "cunet":
        return CUnetGenerator(in_channels=c, num_classes=cfg.num_classes, out_channels=c)
    if kind == "fixed":
        return FixedTriggerGenerator(cfg.input_height, cfg.input_width, c)
    raise ValueError(f"unknown generator kind {kind!r}")


def get_frequency_detector(cfg: Config) -> nn.Module:
    if cfg.F_model in ("original", "original_holdout"):
        return FrequencyModel(num_classes=2, input_size=cfg.input_height, in_channels=cfg.input_channel)
    raise NotImplementedError(f"frequency detector {cfg.F_model!r} {_LATER}")
