from .frequency import FrequencyModel
from .generators import (
    CUnetGenerator,
    FixedTriggerGenerator,
    GridGenerator,
    MixedGenerator,
    UnetDecoder,
    UnetEncoder,
    UnetGenerator,
    UnetGeneratorBK,
)
from .layers import BatchNorm2d, guided_relu, instance_norm
from .preact_resnet import PreActBlock, PreActResNet, preact_resnet18
from .registry import get_classifier, get_frequency_detector, get_generator

__all__ = [
    "BatchNorm2d",
    "CUnetGenerator",
    "FixedTriggerGenerator",
    "FrequencyModel",
    "GridGenerator",
    "MixedGenerator",
    "PreActBlock",
    "PreActResNet",
    "UnetDecoder",
    "UnetEncoder",
    "UnetGenerator",
    "UnetGeneratorBK",
    "get_classifier",
    "get_frequency_detector",
    "get_generator",
    "guided_relu",
    "instance_norm",
    "preact_resnet18",
]
