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
  * a depthwise conv's (kH, kW, 1, O) kernel becomes the grouped
    ``weight`` (O, 1, kH, kW) by the same transpose
  * the ViTs' LayerNorm ``scale`` is ``weight``; their parameters that are
    no layer's (the CLS token, the learned position embedding) keep their
    shape
  * a JAX block named ``<stage>_<i>`` (``layer1_0``, ``dense2_3``) is the
    port's ``<stage>.<i>``; a projection shortcut's ``shortcut_conv`` and
    ``shortcut_bn`` are ``shortcut.0`` and ``shortcut.1``
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
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _out_channels(p: Tree) -> int:
    return int(np.shape(p["kernel"])[-1])


def _layers(sd: Dict[str, torch.Tensor], prefix: str, params: Tree, stats: Tree) -> None:
    """Every conv (``conv*``, ``shortcut*``) and BatchNorm (``bn*``) directly
    under ``params``, by name."""
    for name, p in params.items():
        if name.startswith("bn"):
            _bn(sd, f"{prefix}{name}", p, stats[name])
        elif name.startswith("conv") or name == "shortcut":
            _conv(sd, f"{prefix}{name}" + (".0" if name == "shortcut" else ""), p)
        elif name == "shortcut_conv":
            _conv(sd, f"{prefix}shortcut.0", p)
        elif name == "shortcut_bn":
            _bn(sd, f"{prefix}shortcut.1", p, stats[name])


def _blocks(sd: Dict[str, torch.Tensor], params: Tree, stats: Tree, stage: str) -> None:
    """The blocks ``<stage><s>_<i>`` -> ``<stage><s>.<i>``, each by :func:`_layers`."""
    for name in (k for k in params if k.startswith(stage) and "_" in k):
        _layers(sd, name.replace("_", ".") + ".", params[name], stats[name])


def _resnet(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    """ResNets and PreActResNets of either block; the head reads the
    flattened map of layer4's last conv (512 or 2048 channels)."""
    sd: Dict[str, torch.Tensor] = {}
    _layers(sd, "", params, stats)
    _blocks(sd, params, stats, "layer")
    last = params[max((k for k in params if k.startswith("layer4_")), key=lambda k: int(k.split("_")[1]))]
    _dense(sd, "linear", params["linear"], channels=_out_channels(last["conv3" if "conv3" in last else "conv2"]))
    return sd


def _vgg(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _layers(sd, "", params, stats)
    last = max((k for k in params if k.startswith("conv")), key=lambda k: int(k[len("conv") :]))
    _dense(sd, "classifier", params["classifier"], channels=_out_channels(params[last]))
    return sd


def _mobilenetv2(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _layers(sd, "", params, stats)
    for name in (k for k in params if k.startswith("block")):
        _layers(sd, f"{name}.", params[name], stats[name])
    _dense(sd, "linear", params["linear"], channels=_out_channels(params["conv2"]))
    return sd


def _densenet(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _layers(sd, "", params, stats)
    _blocks(sd, params, stats, "dense")
    for name in (k for k in params if k.startswith("trans")):
        _layers(sd, f"{name}.", params[name], stats[name])
    _dense(sd, "linear", params["linear"], channels=int(np.shape(params["bn"]["scale"])[0]))
    return sd


def _vit(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    """SimpleViT and the timm-style ViT: every Dense, Conv and LayerNorm by
    its path, the CLS token and position embedding as they are."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, tree: Tree) -> None:
        for name, p in tree.items():
            key = f"{prefix}{name}"
            if not isinstance(p, dict):
                sd[key] = _t(p)
            elif "kernel" in p:
                (_conv if np.ndim(p["kernel"]) == 4 else _dense)(sd, key, p)
            elif "scale" in p:
                sd[f"{key}.weight"], sd[f"{key}.bias"] = _t(p["scale"]), _t(p["bias"])
            else:
                walk(f"{key}.", p)

    walk("", params)
    return sd


def _netc_mnist(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _layers(sd, "", params, stats)
    _dense(sd, "linear6", params["linear6"], channels=_out_channels(params["conv4"]))
    _dense(sd, "linear9", params["linear9"])
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
    _layers(sd, "", params, stats)
    _dense(sd, "linear", params["linear"], channels=128)
    return sd


def _frequency_ensemble(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    """The ensemble's one shared ``body``."""
    return {f"body.{k}": v for k, v in _frequency(params["body"], stats["body"]).items()}


_CONVERTERS = {
    "preactresnet": _resnet,
    "preactresnet18": _resnet,
    "vgg": _vgg,
    "mobilenetv2": _mobilenetv2,
    "densenet": _densenet,
    "simplevit": _vit,
    "vit_timm": _vit,
    "netc_mnist": _netc_mnist,
    "resnet": _resnet,
    "unet": _unet,
    "unet_bk": _unet,
    "grid": _grid,
    "mixed": _mixed,
    "cunet": _cunet,
    "fixed": _fixed,
    "frequency": _frequency,
    "frequency_ensemble": _frequency_ensemble,
}


def from_jax_params(tree: Tree, model_kind: str) -> Dict[str, torch.Tensor]:
    """Flax variables (numpy) of ``model_kind`` (a key of ``_CONVERTERS``: the
    classifier, the detector or a generator kind) -> the port model's
    ``state_dict``."""
    if model_kind not in _CONVERTERS:
        raise ValueError(f"unknown model kind {model_kind!r}; options: {sorted(_CONVERTERS)}")
    return _CONVERTERS[model_kind](tree["params"], tree.get("batch_stats", {}))
