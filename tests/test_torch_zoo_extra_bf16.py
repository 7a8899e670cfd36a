"""``--compute_dtype bfloat16`` for the extended zoo and the auxiliary
networks: the dtype of every intermediate against Flax's
``capture_intermediates`` in eval and train mode, and the eval outputs by the
gap criterion of ``combat_tpu_torch/utils/gap.py``, with the JAX package's
float32 and bfloat16 runs as the reference (as
``tests/test_torch_zoo_bf16.py`` holds the rest of the registry).

The families at the narrow widths of ``tests/test_torch_zoo_extra_models.py``;
GoogLeNet and SENet, whose widths are fixed, by their blocks (an Inception
block, an SE pre-activation block), and the full models by which of their
layers the registry puts in bfloat16.  Flax promotes a bfloat16 input of an
``nn.Conv`` without ``dtype=`` to float32: SENet's ``fc1`` reads the
bfloat16 mean of ``conv2`` and computes in float32, and the block's
``out * w + sc`` is float32.  The AE and the Inception block have no layer
with ``dtype=``: they stay float32, and their outputs are held to the JAX
package's at 5e-5, where the criterion holds outputs that both of the
reference's runs leave equal.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from _torch_helpers import nchw, nhwc, to_numpy_tree
from combat_tpu_torch.checkpoint import from_jax_params
from combat_tpu_torch.utils import gap
from test_torch_bf16_models import jax_compute_dtype, one_torch_thread, release_memory
from test_torch_zoo_extra_models import _DPN, _MOBILENET, _SHUFFLE, EFFICIENTNET, _quick_compiles  # noqa: F401

FAMILIES = ("lenet", "mobilenet", "efficientnet", "inception", "dpn", "se_block", "resnext", "shufflenet",
            "shufflenetv2", "pnasnet", "ae", "netc_gtsrb", "netc_mnist2", "netc_mnist3", "netc_celeba")
FLOAT32_FAMILIES = ("inception", "ae")
BLOCKS = ("inception", "se_block", "ae")  # outputs are maps


@pytest.fixture(autouse=True)
def _float32_after():
    """No test of this file leaves the JAX package in low precision."""
    from combat_tpu.models.layers import compute_dtype

    with one_torch_thread():
        release_memory()
        yield
        release_memory()
    assert compute_dtype() is None


def _x(h, c=3, n=8):
    return np.random.default_rng(0).uniform(-1, 1, (n, h, h, c)).astype(np.float32)


def _blocks(variables):
    """A block's state dict: its layers by their Flax names."""
    from combat_tpu_torch.checkpoint.convert import _named

    return _named(variables["params"], variables.get("batch_stats", {}), {})


def _family(name):
    """(JAX module, port constructor, converter, input).  A JAX module reads
    the compute dtype when it is traced, so one module serves both runs."""
    from combat_tpu.models import misc as JM
    from combat_tpu.models import zoo_extra as JZ

    from combat_tpu_torch.models import misc as PM
    from combat_tpu_torch.models import zoo_extra as PZ

    kind = {"lenet": "lenet", "mobilenet": "mobilenet", "efficientnet": "efficientnet", "dpn": "dpn",
            "resnext": "resnext", "shufflenet": "shufflenet", "shufflenetv2": "shufflenetv2", "pnasnet": "pnasnet",
            "ae": "ae", "netc_gtsrb": "netc_gtsrb", "netc_mnist2": "netc_mnist2", "netc_mnist3": "netc_mnist3",
            "netc_celeba": "netc_celeba"}
    resnext = dict(cardinality=4, bottleneck_width=2, num_blocks=(1, 1, 2))
    v2 = dict(out_channels=(16, 32, 64, 128), num_blocks=(1, 2, 1))
    jax_module, make, x = {
        "lenet": (JZ.LeNet(10), lambda: PZ.LeNet(10), _x(32)),
        "mobilenet": (JZ.MobileNetV1(10, cfg=_MOBILENET), lambda: PZ.MobileNetV1(10, cfg=_MOBILENET), _x(32)),
        "efficientnet": (JZ.EfficientNetB0(10, cfg=EFFICIENTNET), lambda: PZ.EfficientNetB0(10, cfg=EFFICIENTNET),
                         _x(32)),
        "inception": (JZ.Inception(8, 8, 12, 4, 6, 6), lambda: PZ.Inception(16, 8, 8, 12, 4, 6, 6), _x(8, 16)),
        "dpn": (JZ.DPN(10, **_DPN), lambda: PZ.DPN(10, **_DPN), _x(32)),
        "se_block": (JZ.SEPreActBlock(32, 2), lambda: PZ.SEPreActBlock(16, 32, 2), _x(8, 16)),
        "resnext": (JZ.ResNeXt29(10, **resnext), lambda: PZ.ResNeXt29(10, **resnext), _x(32)),
        "shufflenet": (JZ.ShuffleNetG2(10, **_SHUFFLE), lambda: PZ.ShuffleNetG2(10, **_SHUFFLE), _x(32)),
        "shufflenetv2": (JZ.ShuffleNetV2(10, **v2), lambda: PZ.ShuffleNetV2(10, **v2), _x(32)),
        "pnasnet": (JZ.PNASNet(10, cell="A", num_planes=8), lambda: PZ.PNASNet(10, cell="A", num_planes=8),
                    _x(32)),
        "ae": (JM.AE(), lambda: PM.AE(3), _x(32)),
        "netc_gtsrb": (JM.NetC_GTRSB(), lambda: PM.NetC_GTRSB(), _x(32)),
        "netc_mnist2": (JM.NetC_MNIST2(), lambda: PM.NetC_MNIST2(), _x(28, 1)),
        "netc_mnist3": (JM.NetC_MNIST3(), lambda: PM.NetC_MNIST3(), _x(28, 1)),
        "netc_celeba": (JM.NetC_CelebA(), lambda: PM.NetC_CelebA(), _x(64)),
    }[name]
    convert = _blocks if name in ("inception", "se_block") else (lambda v: from_jax_params(v, kind[name]))
    return jax_module, make, convert, x


def _dtypes(tree):
    return [str(a.dtype).replace("torch.", "") for a in jax.tree.leaves(tree)]


def _flax_dtypes(intermediates):
    """Each Flax submodule's output dtypes by the port's module name (the
    Flax path joined by dots); the dropouts (one module a place in the
    port) left out."""
    out = {}
    for path, value in traverse_util.flatten_dict(intermediates).items():
        if not any(p.startswith("Dropout_") for p in path):
            out[".".join(path[:-1])] = _dtypes(value)
    return out


def _port_dtypes(model, x):
    seen = {}
    hooks = [m.register_forward_hook(lambda mod, inp, out, n=n: seen.__setitem__(n, _dtypes(out)))
             for n, m in model.named_modules()]
    with torch.no_grad():
        out = model(nchw(x))
    for h in hooks:
        h.remove()
    return seen, out


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_intermediates_and_outputs_match_flax(name):
    """In eval and train mode, every module output of the port (forward
    hooks) has the dtype of the Flax submodule of the same name, and every
    port module with parameters has a Flax counterpart; the eval outputs in
    bfloat16 pass the gap criterion against the JAX package's two runs,
    from one set of converted weights."""
    from combat_tpu_torch.models import set_compute_dtype

    jm, make, convert, x = _family(name)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))
    sd = convert(to_numpy_tree(variables))
    jax_f32 = jax.jit(partial(jm.apply, train=False))(variables, jnp.asarray(x))
    lows = {}
    for train in (False, True):
        mutable = ["intermediates", "batch_stats"] if train and "batch_stats" in variables else ["intermediates"]
        with jax_compute_dtype("bfloat16"):
            out, state = jax.jit(partial(jm.apply, train=train, capture_intermediates=True, mutable=mutable))(
                variables, jnp.asarray(x), rngs={"dropout": jax.random.key(1)})
        flax_by_name = _flax_dtypes(state["intermediates"])
        model = set_compute_dtype(make(), torch.bfloat16)
        model.load_state_dict(sd)
        seen, port_out = _port_dtypes(model.train(train), x)
        weighted = {n for n, m in model.named_modules() if list(m.parameters(recurse=False))} | {""}
        assert weighted <= set(flax_by_name), sorted(weighted - set(flax_by_name))
        mismatched = {n: (seen.get(n), d) for n, d in flax_by_name.items() if seen.get(n) != d}
        assert not mismatched, (train, mismatched)
        values = set(sum(flax_by_name.values(), []))
        assert values == ({"float32"} if name in FLOAT32_FAMILIES else {"bfloat16", "float32"}), values
        if not train:
            lows = {"jax": out, "port": port_out}
    if name == "se_block":
        assert flax_by_name["conv2"] == ["bfloat16"] and flax_by_name["fc1"] == flax_by_name[""] == ["float32"]
    if name == "lenet":
        assert flax_by_name["Conv_0"] == flax_by_name["Conv_1"] == ["float32"] and flax_by_name["fc1"] == ["bfloat16"]
    if name == "efficientnet":
        assert flax_by_name["block0.se1"] == ["float32"] and flax_by_name["block0.conv3"] == ["bfloat16"]

    model = make()
    model.load_state_dict(sd)
    with torch.no_grad():
        port_f32 = model.eval()(nchw(x))
    show = nhwc if name in BLOCKS else (lambda t: t.detach().float().numpy())
    port_lo = lows["port"]
    assert str(port_lo.dtype).replace("torch.", "") == str(lows["jax"].dtype)
    failure = gap.gap_failure(f"{name} outputs", show(port_lo), show(port_f32), np.asarray(lows["jax"], np.float32),
                              np.asarray(jax_f32), "ab" if name in FLOAT32_FAMILIES else "abc")
    assert failure is None, failure


# the port's float32 convolutions (Flax's nn.Conv without dtype=), by name, in each model
FLOAT32_CONVS = {
    "lenet": lambda n: n in ("Conv_0", "Conv_1"),
    "efficientnetb0": lambda n: n.endswith((".se1", ".se2")),
    "googlenet": lambda n: True,
    "senet18": lambda n: n.endswith((".fc1", ".fc2")),
}


@pytest.mark.parametrize("name", ["lenet", "mobilenet", "efficientnetb0", "googlenet", "dpn26", "dpn92", "senet18",
                                  "shufflenetg2", "shufflenetv2", "resnext29_2x64d", "resnext29_32x4d", "pnasneta",
                                  "pnasnetb"])
def test_registry_puts_the_flax_dtype_layers_in_bfloat16(name):
    """``--compute_dtype bfloat16`` through the registry: every convolution
    and linear the JAX package builds with ``dtype=`` computes in bfloat16,
    and those it builds without stay ``torch.nn``'s float32 layers."""
    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier

    model = get_classifier(apply_dataset_preset(Config(model=name, compute_dtype="bfloat16")))
    float32 = FLOAT32_CONVS.get(name, lambda n: False)
    layers = [(n, m) for n, m in model.named_modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    assert layers
    for n, m in layers:
        low = getattr(m, "compute_dtype", None) == torch.bfloat16
        assert low != (isinstance(m, torch.nn.Conv2d) and float32(n)), n
