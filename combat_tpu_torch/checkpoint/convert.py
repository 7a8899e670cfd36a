"""Carry the JAX package's parameters into the port's ``state_dict``s.

The inverse of ``combat_tpu/checkpoint/torch_import.py:65-80``, for the
port's own module names.  The input is the Flax variables as a tree of
numpy arrays (``{"params": ..., "batch_stats": ...}``; convert JAX arrays
with ``np.asarray`` first); the output is a ``state_dict`` of CPU tensors:

  * conv ``kernel`` (kH, kW, I, O) -> ``weight`` (O, I, kH, kW)
  * dense ``kernel`` (F, O) -> ``weight`` (O, F); a head that reads a
    flattened conv map has its F axis permuted from Flax's (H, W, C) order
    to PyTorch's (C, H, W) order
  * BatchNorm ``scale/bias`` and ``mean/var`` -> ``weight/bias`` and
    ``running_mean/running_var`` (``num_batches_tracked`` set to 0)
  * the flow head's ``fc1``/``fc2`` of the grid and mixed generators keep
    their order: the JAX ``reshape((-1, 2, s, s))`` comes before its
    transpose, so ``fc2``'s outputs are already the port's (2, s, s)
  * the class-conditional UNet's top-level convs go under ``enc``; its
    ``conv0_1`` reads ``nf + num_classes`` channels in the JAX concat order
    ``[f0, one_hot]``, which is the port's
  * the fixed trigger goes from (H, W, C) to (C, H, W)
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

Tree = Dict[str, Any]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _conv(sd: Dict[str, torch.Tensor], prefix: str, p: Tree) -> None:
    sd[f"{prefix}.weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _bn(sd: Dict[str, torch.Tensor], prefix: str, p: Tree, s: Tree) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _dense(sd: Dict[str, torch.Tensor], prefix: str, p: Tree, channels: int = 0) -> None:
    """``channels`` > 0: the input is a flattened (H, W, channels) map."""
    w = np.asarray(p["kernel"]).T  # (O, F)
    if channels:
        side = int(round((w.shape[1] / channels) ** 0.5))
        w = w.reshape(w.shape[0], side, side, channels).transpose(0, 3, 1, 2).reshape(w.shape[0], -1)
    sd[f"{prefix}.weight"] = _t(w)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _preact_resnet(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "conv1", params["conv1"])
    for name in sorted(k for k in params if k.startswith("layer")):
        stage, i = name[len("layer") :].split("_")
        prefix = f"layer{stage}.{i}"
        block, block_stats = params[name], stats[name]
        for bn in ("bn1", "bn2"):
            _bn(sd, f"{prefix}.{bn}", block[bn], block_stats[bn])
        for cv in ("conv1", "conv2"):
            _conv(sd, f"{prefix}.{cv}", block[cv])
        if "shortcut" in block:
            _conv(sd, f"{prefix}.shortcut.0", block["shortcut"])
    _dense(sd, "linear", params["linear"], channels=512)
    return sd


def _resnet(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    """BasicBlock and Bottleneck ResNets: the JAX block's ``shortcut_conv``
    and ``shortcut_bn`` are the port's ``shortcut.0`` and ``shortcut.1``; the
    head reads the flattened map of layer4's last conv (512 or 2048
    channels)."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "conv1", params["conv1"])
    _bn(sd, "bn1", params["bn1"], stats["bn1"])
    blocks = sorted(k for k in params if k.startswith("layer"))
    for name in blocks:
        stage, i = name[len("layer") :].split("_")
        prefix = f"layer{stage}.{i}"
        block, block_stats = params[name], stats[name]
        for j in (1, 2, 3):
            if f"conv{j}" in block:
                _conv(sd, f"{prefix}.conv{j}", block[f"conv{j}"])
                _bn(sd, f"{prefix}.bn{j}", block[f"bn{j}"], block_stats[f"bn{j}"])
        if "shortcut_conv" in block:
            _conv(sd, f"{prefix}.shortcut.0", block["shortcut_conv"])
            _bn(sd, f"{prefix}.shortcut.1", block["shortcut_bn"], block_stats["shortcut_bn"])
    last = params[max((k for k in blocks if k.startswith("layer4_")), key=lambda k: int(k.split("_")[1]))]
    channels = np.shape(last["conv3" if "conv3" in last else "conv2"]["kernel"])[-1]
    _dense(sd, "linear", params["linear"], channels=channels)
    return sd


def _unet(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for part in ("enc", "dec"):
        for name, p in params[part].items():
            _conv(sd, f"{part}.{name}", p)
    return sd


def _grid(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params["enc"].items():
        _conv(sd, f"enc.{name}", p)
    for fc in ("fc1", "fc2"):
        _dense(sd, f"head.{fc}", params[fc])
    return sd


def _mixed(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    return {**_unet(params, stats), **_grid(params, stats)}


def _cunet(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if name != "dec":
            _conv(sd, f"enc.{name}", p)
    for name, p in params["dec"].items():
        _conv(sd, f"dec.{name}", p)
    return sd


def _fixed(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    return {"trigger": _t(np.transpose(params["trigger"], (2, 0, 1)))}


def _frequency(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for i in range(6):
        _conv(sd, f"conv{i}", params[f"conv{i}"])
        _bn(sd, f"bn{i}", params[f"bn{i}"], stats[f"bn{i}"])
    _dense(sd, "linear", params["linear"], channels=128)
    return sd


_CONVERTERS = {
    "preactresnet18": _preact_resnet,
    "resnet": _resnet,
    "unet": _unet,
    "unet_bk": _unet,
    "grid": _grid,
    "mixed": _mixed,
    "cunet": _cunet,
    "fixed": _fixed,
    "frequency": _frequency,
}


def from_jax_params(tree: Tree, model_kind: str) -> Dict[str, torch.Tensor]:
    """Flax variables (numpy) of ``model_kind`` (a key of ``_CONVERTERS``: the
    classifier, the detector or a generator kind) -> the port model's
    ``state_dict``."""
    if model_kind not in _CONVERTERS:
        raise ValueError(f"unknown model kind {model_kind!r}; options: {sorted(_CONVERTERS)}")
    return _CONVERTERS[model_kind](tree["params"], tree.get("batch_stats", {}))
