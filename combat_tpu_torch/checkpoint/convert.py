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
  * the extended zoo (``models/zoo_extra.py``) and the auxiliary networks
    (``models/misc.py``) keep the Flax names, so each layer's key is its
    Flax path joined by dots (:func:`_named`); a grouped conv's (kH, kW,
    I / groups, O) kernel becomes (O, I / groups, kH, kW) by the same
    transpose
  * the AE decoder's ``ConvTranspose`` (kH, kW, I, O) kernel, which Flax
    applies unflipped, becomes ``ConvTranspose2d``'s (I, O, kH, kW) weight
    flipped in both spatial axes
"""

from __future__ import annotations

import re
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


def _in_channels(p: Tree) -> int:
    return int(np.shape(p["kernel"])[-2])


def _last(params: Tree, prefix: str) -> str:
    """The last of the keys ``<prefix><i>`` / ``<prefix><s>_<i>`` by their numbers."""
    keys = [k for k in params if k.startswith(prefix) and k[len(prefix):][:1].isdigit()]
    return max(keys, key=lambda k: tuple(int(v) for v in re.findall(r"\d+", k[len(prefix):])))


def _named(params: Tree, stats: Tree, heads: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """Every conv, dense and BatchNorm of a model whose port modules carry
    the Flax names; ``heads`` maps each dense that reads a flattened map to
    the map's channels."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, tree: Tree, st: Tree) -> None:
        for name, p in tree.items():
            key = f"{prefix}{name}"
            if "kernel" in p:
                (_conv(sd, key, p) if np.ndim(p["kernel"]) == 4 else _dense(sd, key, p, channels=heads.get(key, 0)))
            elif "scale" in p:
                _bn(sd, key, p, st[name])
            else:
                walk(f"{key}.", p, st.get(name, {}))

    walk("", params, stats)
    return sd


def _lenet(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    return _named(params, stats, {"fc1": _out_channels(params["Conv_1"])})


def _mobilenet(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    last = max(int(k[1:].split("_")[0]) for k in params if k.endswith("_pw"))
    return _named(params, stats, {"linear": _out_channels(params[f"b{last}_pw"])})


def _efficientnet(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    return _named(params, stats, {})  # the head reads the spatial mean


def _googlenet(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    b5 = params["b5"]
    return _named(params, stats, {"linear": sum(_out_channels(b5[b]) for b in ("b1", "b2b", "b3c", "b4"))})


def _dpn(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    """The head reads the last block's input plus the last stage's dense
    depth, which is the second block's input less the first's conv3 width."""
    blocks = sorted((k for k in params if k.startswith("s3_")), key=lambda k: int(k.split("_")[1]))
    if len(blocks) < 2:
        raise ValueError("a DPN whose last stage has one block: its dense depth is not in the parameters")
    depth = _in_channels(params[blocks[1]]["conv1"]) - _out_channels(params[blocks[0]]["conv3"])
    return _named(params, stats, {"linear": _in_channels(params[blocks[-1]]["conv1"]) + depth})


def _senet(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    return _named(params, stats, {"linear": _out_channels(params[_last(params, "layer")]["conv2"])})


def _resnext(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    return _named(params, stats, {"linear": _out_channels(params[_last(params, "layer")]["conv3"])})


def _shufflenet(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    """A stage's first block (stride 2) concatenates its input's pool."""
    name = _last(params, "s")
    block = params[name]
    first = name.endswith("_0")
    return _named(params, stats, {"linear": _out_channels(block["conv3"]) + (_in_channels(block["conv1"]) if first
                                                                            else 0)})


def _shufflenetv2(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    return _named(params, stats, {"linear": _out_channels(params["conv2"])})


def _pnasnet(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    return _named(params, stats, {"linear": _out_channels(params[_last(params, "cell")]["sep1"]["conv1"])})


def _ae(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    sd = _named(params, stats, {})
    for name, p in params["decoder"].items():
        if name.endswith("_conv"):
            sd[f"decoder.{name}.weight"] = _t(np.transpose(p["kernel"], (2, 3, 0, 1))[:, :, ::-1, ::-1].copy())
    return sd


def _netc_gtsrb(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    return _named(params, stats, {"linear1": _out_channels(params["block6"]["conv"])})


def _netc_mnist2(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    return _named(params, stats, {"linear6": _out_channels(params["layer4"]["conv1"])})


def _netc_mnist3(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    return _named(params, stats, {"linear6": _out_channels(params["layer3"]["conv1"])})


def _netc_celeba(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    return _named(params, stats, {"linear12": _out_channels(params["conv3"])})


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
    "lenet": _lenet,
    "mobilenet": _mobilenet,
    "efficientnet": _efficientnet,
    "googlenet": _googlenet,
    "dpn": _dpn,
    "senet": _senet,
    "resnext": _resnext,
    "shufflenet": _shufflenet,
    "shufflenetv2": _shufflenetv2,
    "pnasnet": _pnasnet,
    "ae": _ae,
    "netc_gtsrb": _netc_gtsrb,
    "netc_mnist2": _netc_mnist2,
    "netc_mnist3": _netc_mnist3,
    "netc_celeba": _netc_celeba,
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
