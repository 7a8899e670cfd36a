"""Model factories (the port of ``combat_tpu/models/registry.py``).

Every ``--model`` name of the JAX registry's ``CLASSIFIERS`` builds for any
dataset, as there, with its head sized from the dataset's map; where the
JAX model cannot be built at a size (a pool that leaves no map), neither can
the port's.  Each dataset has its default (mnist's is ``NetC_MNIST``).
``--F_model`` takes ``original`` (and ``original_holdout``),
``original_dropout``, ``original_dropout_ensemble`` (dropout live in eval
mode) or any classifier name, built with two classes.

Every model is built in ``cfg.compute_dtype`` (``layers.py``), the frozen
clean model and the detector too, as every module of the JAX package reads
its compute dtype; the layers the JAX package keeps in float32 (the ViTs,
the convolutions it builds without ``dtype=``) are ``torch.nn``'s own and
stay float32.
"""

from __future__ import annotations

from functools import partial

import torch.nn as nn

from ..config import Config
from .densenet import densenet121
from .frequency import FrequencyModel, FrequencyModelDropoutEnsemble, frequency_model_dropout
from .generators import (
    CUnetGenerator,
    FixedTriggerGenerator,
    GridGenerator,
    MixedGenerator,
    UnetGenerator,
    UnetGeneratorBK,
)
from .layers import parse_compute_dtype, set_compute_dtype
from .misc import NetC_MNIST
from .mobilenetv2 import mobilenetv2
from .preact_resnet import preact_resnet10, preact_resnet18, preact_resnet34
from .resnet import resnet18, resnet34
from .vgg import vgg
from .vit import simplevitsmall8, vit, vitsmall
from .zoo_extra import (
    EfficientNetB0,
    GoogLeNet,
    LeNet,
    MobileNetV1,
    SENet18,
    ShuffleNetG2,
    ShuffleNetV2,
    dpn26,
    dpn92,
    pnasnet_a,
    pnasnet_b,
    resnext29_2x64d,
    resnext29_32x4d,
)

# --model names (the JAX registry's CLASSIFIERS): (num_classes, input_size, in_channels) -> module
CLASSIFIERS = {
    "preactresnet18": preact_resnet18,
    "preactresnet10": preact_resnet10,
    "preactresnet34": preact_resnet34,
    "resnet18": resnet18,
    "resnet34": resnet34,
    "vgg11": partial(vgg, "VGG11"),
    "vgg13": partial(vgg, "VGG13"),
    "vgg16": partial(vgg, "VGG16"),
    "vgg19": partial(vgg, "VGG19"),
    "mobilenetv2": mobilenetv2,
    "densenet121": densenet121,
    "vit": vit,
    "simplevitsmall8": simplevitsmall8,
    "vitsmall": vitsmall,
    # the latent experiment zoo (reference classifier_models/{lenet,mobilenet,...}.py)
    "lenet": LeNet,
    "mobilenet": MobileNetV1,
    "efficientnetb0": EfficientNetB0,
    "googlenet": GoogLeNet,
    "dpn26": dpn26,
    "dpn92": dpn92,
    "senet18": SENet18,
    "shufflenetg2": ShuffleNetG2,
    "shufflenetv2": ShuffleNetV2,
    "resnext29_2x64d": resnext29_2x64d,
    "resnext29_32x4d": resnext29_32x4d,
    "pnasneta": pnasnet_a,
    "pnasnetb": pnasnet_b,
}
# each dataset's default (combat_tpu/models/registry.py::get_classifier)
_DEFAULTS = {"cifar10": preact_resnet18, "gtsrb": preact_resnet18, "celeba": resnet18, "imagenet10": resnet18,
             "mnist": NetC_MNIST}


def _named_classifier(name: str, num_classes: int, cfg: Config) -> nn.Module:
    if name not in CLASSIFIERS:
        raise ValueError(f"unknown classifier {name!r}; options: {sorted(CLASSIFIERS)}")
    return CLASSIFIERS[name](num_classes, cfg.input_height, cfg.input_channel)


def get_classifier(cfg: Config) -> nn.Module:
    """Default classifier per dataset; a named model is built for any
    dataset, as in the JAX registry."""
    if cfg.model != "default":
        return _in_dtype(cfg, _named_classifier(cfg.model, cfg.num_classes, cfg))
    if cfg.dataset not in _DEFAULTS:
        raise ValueError(f"no default classifier for dataset {cfg.dataset!r}")
    return _in_dtype(cfg, _DEFAULTS[cfg.dataset](cfg.num_classes, cfg.input_height, cfg.input_channel))


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
    """Frequency detector per ``--F_model`` (reference F_MAPPING_NAMES,
    ``train_generator.py:35-44,112-120``)."""
    name, h, c = cfg.F_model, cfg.input_height, cfg.input_channel
    if name in ("original", "original_holdout"):
        return _in_dtype(cfg, FrequencyModel(num_classes=2, input_size=h, in_channels=c))
    if name == "original_dropout":
        return _in_dtype(cfg, frequency_model_dropout(2, cfg.F_dropout, h, c))
    if name == "original_dropout_ensemble":
        return _in_dtype(cfg, FrequencyModelDropoutEnsemble(2, cfg.F_dropout, cfg.F_num_ensemble, h, c))
    if name in CLASSIFIERS:
        return _in_dtype(cfg, _named_classifier(name, 2, cfg))
    raise ValueError(f"unknown frequency detector {name!r}")


def _in_dtype(cfg: Config, model: nn.Module) -> nn.Module:
    return set_compute_dtype(model, parse_compute_dtype(cfg.compute_dtype))
