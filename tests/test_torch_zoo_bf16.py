"""``--compute_dtype bfloat16`` for the rest of the model registry: the dtype
of every intermediate against Flax's ``capture_intermediates``, and the
logits by the gap criterion of ``combat_tpu_torch/utils/gap.py``, with the
JAX package's float32 and bfloat16 runs as the reference (as
``tests/test_torch_bf16_models.py`` holds the ResNets, the generators and
the detector).

The families at the narrow widths of ``tests/test_torch_zoo_models.py``.
No layer of the JAX ViTs passes ``dtype=``, so they stay float32 under
bfloat16 compute, and so do the port's (their logits are held to the JAX
package's at 5e-5, where the criterion holds outputs that both of the
reference's runs leave equal).  NetC_MNIST's convolutions pass no
``dtype=`` and its linears do: float32 convolutions, bfloat16 linears.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from _torch_helpers import nchw, to_numpy_tree
from combat_tpu_torch.checkpoint import from_jax_params
from combat_tpu_torch.utils import gap
from test_torch_bf16_models import jax_compute_dtype, one_torch_thread, release_memory

FAMILIES = ("preact_bottleneck", "vgg", "mobilenetv2", "densenet", "simplevit", "vit_timm", "netc_mnist")
FLOAT32_FAMILIES = ("simplevit", "vit_timm")


@pytest.fixture(autouse=True)
def _float32_after():
    """No test of this file leaves the JAX package in low precision."""
    from combat_tpu.models.layers import compute_dtype

    with one_torch_thread():
        release_memory()
        yield
        release_memory()
    assert compute_dtype() is None


_SHORT_MOBILENET = ((1, 8, 1, 1), (6, 16, 2, 2), (6, 24, 1, 2))


def _family(name, monkeypatch, dtype=None):
    """(JAX module, port constructor in ``dtype``, converter kind, input).
    A JAX module reads the compute dtype when it is traced, so one module
    serves both of its runs."""
    import importlib

    from combat_tpu.models.misc import NetC_MNIST as JaxNetC

    from combat_tpu_torch import models as P

    # the modules by path: both packages export functions named as some of them
    JD, JM, JP, JV, JT = (importlib.import_module(f"combat_tpu.models.{m}")
                          for m in ("densenet", "mobilenetv2", "preact_resnet", "vgg", "vit"))
    PM = importlib.import_module("combat_tpu_torch.models.mobilenetv2")
    monkeypatch.setattr(JM, "CFG", _SHORT_MOBILENET)
    monkeypatch.setattr(PM, "CFG", _SHORT_MOBILENET)
    x = np.random.default_rng(0).uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    vgg_cfg = (8, "M", 16, 16, "M", 16, "M", 24, "M", 24, "M")
    vit = dict(image_size=32, patch_size=8, num_classes=10, dim=32, depth=2, heads=2)
    jax_module, make, kind = {
        "preact_bottleneck": (JP.PreActResNet([1, 1, 1, 1], 10, bottleneck=True),
                              lambda: P.PreActResNet((1, 1, 1, 1), 10, bottleneck=True), "preactresnet"),
        "vgg": (JV.VGG(vgg_cfg, 10), lambda: P.VGG(vgg_cfg, 10), "vgg"),
        "mobilenetv2": (JM.MobileNetV2(10), lambda: PM.MobileNetV2(10), "mobilenetv2"),
        "densenet": (JD.DenseNet([2, 1, 2, 1], growth_rate=4), lambda: P.DenseNet((2, 1, 2, 1), 4), "densenet"),
        "simplevit": (JT.SimpleViT(**vit, mlp_dim=64, dim_head=16), lambda: P.SimpleViT(**vit, mlp_dim=64,
                                                                                          dim_head=16), "simplevit"),
        "vit_timm": (JT.VisionTransformer(**vit), lambda: P.VisionTransformer(**vit), "vit_timm"),
        "netc_mnist": (JaxNetC(10), lambda: P.NetC_MNIST(10), "netc_mnist"),
    }[name]
    if name == "netc_mnist":
        x = x[:, 2:30, 2:30, :1].copy()
    return jax_module, lambda: P.set_compute_dtype(make(), dtype), kind, x


def _dtypes(tree):
    return [str(a.dtype).replace("torch.", "") for a in jax.tree.leaves(tree)]


def _port_name(path):
    """A Flax module path -> the port's module name; None for a Dropout
    (one module the port calls at each place)."""
    out = []
    for part in path:
        stage, _, index = part.rpartition("_")
        if part.startswith("Dropout"):
            return None
        if part in ("shortcut", "shortcut_conv"):
            out.extend(["shortcut", "0"])
        elif part == "shortcut_bn":
            out.extend(["shortcut", "1"])
        elif stage.startswith(("layer", "dense")) and index.isdigit():
            out.extend([stage, index])
        else:
            out.append(part)
    return ".".join(out)


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("train", [False, True])
def test_bf16_intermediate_dtypes_match_flax(name, train, monkeypatch):
    """Every module output of the port (forward hooks) has the dtype of the
    Flax submodule of the same name; every port module with parameters has
    a Flax counterpart.  Train mode runs BatchNorm on batch statistics."""
    jm, make, kind, x = _family(name, monkeypatch, torch.bfloat16)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))
    mutable = ["intermediates", "batch_stats"] if train and "batch_stats" in variables else ["intermediates"]
    with jax_compute_dtype("bfloat16"):
        _, state = jax.jit(partial(jm.apply, train=train, capture_intermediates=True, mutable=mutable))(
            variables, jnp.asarray(x), rngs={"dropout": jax.random.key(1)})
    flax_by_name = {}
    for path, value in traverse_util.flatten_dict(state["intermediates"]).items():
        port = _port_name(path[:-1])
        if port is not None:
            flax_by_name[port] = _dtypes(value)

    model = make()
    model.load_state_dict(from_jax_params(to_numpy_tree(variables), kind))
    model.train(train)
    seen = {}
    hooks = [m.register_forward_hook(lambda mod, inp, out, n=n: seen.__setitem__(n, _dtypes(out)))
             for n, m in model.named_modules()]
    with torch.no_grad():
        model(nchw(x))
    for h in hooks:
        h.remove()

    weighted = {n for n, m in model.named_modules() if list(m.parameters(recurse=False))} | {""}
    assert weighted <= set(flax_by_name), sorted(weighted - set(flax_by_name))
    mismatched = {n: (seen[n], d) for n, d in flax_by_name.items() if seen.get(n) != d}
    assert not mismatched, mismatched
    values = sum(flax_by_name.values(), [])
    if name in FLOAT32_FAMILIES:
        assert set(values) == {"float32"}
    else:
        assert {"bfloat16", "float32"} <= set(values)
    if name == "netc_mnist":
        assert [flax_by_name[f"conv{i}"] for i in (1, 2, 3, 4)] == [["float32"]] * 4
        assert flax_by_name["linear6"] == flax_by_name["linear9"] == ["bfloat16"]


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_logits_pass_the_gap_criterion(name, monkeypatch):
    """Eval logits of each family in bfloat16 against the JAX package's two
    runs, from one set of converted weights; the ViTs' logits stay float32
    and equal the JAX package's (which bfloat16 does not change)."""
    jm, _, kind, x = _family(name, monkeypatch)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))
    sd = from_jax_params(to_numpy_tree(variables), kind)

    def jax_out():  # a jit of its own each time: traced in the compute dtype set now
        return jax.jit(partial(jm.apply, train=False))(variables, jnp.asarray(x))

    def port_out(dtype):
        model = _family(name, monkeypatch, dtype)[1]()
        model.load_state_dict(sd)
        with torch.no_grad():
            return model.eval()(nchw(x))

    jax_f32 = jax_out()
    with jax_compute_dtype("bfloat16"):
        jax_lo = jax_out()
    port_f32, port_lo = port_out(None), port_out(torch.bfloat16)
    assert str(port_lo.dtype).replace("torch.", "") == str(jax_lo.dtype)
    assert (port_lo.dtype == torch.float32) == (name in FLOAT32_FAMILIES)
    failure = gap.gap_failure(f"{name} logits", port_lo.float().numpy(), port_f32.numpy(),
                              np.asarray(jax_lo, np.float32), np.asarray(jax_f32),
                              "ab" if name in FLOAT32_FAMILIES else "abc")
    assert failure is None, failure


def test_registry_leaves_the_vits_in_float32():
    """``--compute_dtype bfloat16`` through the registry: the ViTs keep
    every layer in float32, NetC_MNIST its convolutions, and the other new
    families compute their convolutions and linears in bfloat16."""
    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier

    cfg = apply_dataset_preset(Config(compute_dtype="bfloat16"))
    for name in ("vit", "simplevitsmall8", "vitsmall"):
        model = get_classifier(cfg.replace(model=name))
        assert not any(hasattr(m, "compute_dtype") for m in model.modules()), name
    mnist = get_classifier(apply_dataset_preset(Config(dataset="mnist", compute_dtype="bfloat16")))
    assert [m.compute_dtype for m in (mnist.linear6, mnist.linear9)] == [torch.bfloat16] * 2
    assert not hasattr(mnist.conv1, "compute_dtype")
    for name in ("preactresnet34", "vgg11", "mobilenetv2", "densenet121"):
        layers = [m for m in get_classifier(cfg.replace(model=name)).modules() if hasattr(m, "compute_dtype")]
        assert layers and all(m.compute_dtype == torch.bfloat16 for m in layers), name
