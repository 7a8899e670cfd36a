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
from .layers import BatchNorm2d, Conv2d, Linear, guided_relu, instance_norm, parse_compute_dtype, set_compute_dtype
from .preact_resnet import PreActBlock, PreActResNet, preact_resnet18
from .resnet import BasicBlock, Bottleneck, ResNet, resnet18, resnet34, resnet50, resnet101, resnet152
from .registry import get_classifier, get_frequency_detector, get_generator

__all__ = [
    "BasicBlock",
    "BatchNorm2d",
    "Bottleneck",
    "CUnetGenerator",
    "Conv2d",
    "FixedTriggerGenerator",
    "FrequencyModel",
    "GridGenerator",
    "Linear",
    "MixedGenerator",
    "PreActBlock",
    "PreActResNet",
    "ResNet",
    "UnetDecoder",
    "UnetEncoder",
    "UnetGenerator",
    "UnetGeneratorBK",
    "get_classifier",
    "get_frequency_detector",
    "get_generator",
    "guided_relu",
    "instance_norm",
    "parse_compute_dtype",
    "preact_resnet18",
    "resnet101",
    "resnet152",
    "resnet18",
    "resnet34",
    "resnet50",
    "set_compute_dtype",
]
