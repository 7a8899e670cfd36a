"""The rest of the model registry: every ``--model`` name outside the JAX
package's ``zoo_extra.py``, mnist's default and the detector variants,
against the JAX models (``zoo_extra.py``'s names and ``misc.py``'s other
networks: ``tests/test_torch_zoo_extra_models.py``).

Structure at full width without compiling: each port model's parameter
count equals the Flax model's (``jax.eval_shape`` of its ``init``) at
cifar10 (32 px), celeba (64 px) and imagenet10 (224 px), and mnist (28 px,
one channel) for NetC_MNIST.  Forwards at narrow widths through the JAX
constructors' own arguments (a short VGG ``cfg``, ``DenseNet(nblocks,
growth_rate)``, small ViTs, ``PreActResNet(num_blocks, bottleneck=True)``,
MobileNetV2 block by block and with a short block table), with the port
loaded through ``from_jax_params``: eval-mode logits, and train-mode logits
with the updated BatchNorm statistics, at the tolerance of
``tests/test_torch_models.py`` (1e-4 absolute and relative; float32
convolutions summed in another order).  Each head that reads a map larger
than 1x1 is held at 64 px too (28 px for NetC_MNIST).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import assert_state_close, nchw, nhwc, to_numpy_tree
from combat_tpu_torch.checkpoint import from_jax_params

TOL = dict(atol=1e-4, rtol=1e-4)
DATASETS = ("cifar10", "celeba", "imagenet10")
NAMES = ("preactresnet10", "preactresnet34", "vgg11", "vgg13", "vgg16", "vgg19", "mobilenetv2", "densenet121",
         "vit", "simplevitsmall8", "vitsmall")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_count(module, h: int, c: int) -> int:
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.zeros((1, h, h, c))))
    return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))


def _port_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _configs(dataset: str, **kw):
    from combat_tpu.config import Config as JaxConfig
    from combat_tpu.config import apply_dataset_preset as jax_preset

    from combat_tpu_torch.config import Config, apply_dataset_preset

    return jax_preset(JaxConfig(dataset=dataset, **kw)), apply_dataset_preset(Config(dataset=dataset, **kw))


@pytest.mark.parametrize("name", NAMES)
def test_classifier_parameter_count_equals_flax(name):
    """``--model name`` at cifar10, celeba and imagenet10: the port's
    registry builds the Flax registry's geometry (the heads sized from each
    input's pooled map, vitsmall's patch ``max(1, H // 16)``)."""
    from combat_tpu.models.registry import get_classifier as jax_classifier

    from combat_tpu_torch.models import get_classifier

    for dataset in DATASETS:
        jcfg, cfg = _configs(dataset, model=name)
        h, c = cfg.input_height, cfg.input_channel
        assert _port_count(get_classifier(cfg)) == _jax_count(jax_classifier(jcfg), h, c), dataset


@pytest.mark.parametrize("F_model", ["original_dropout", "original_dropout_ensemble", "densenet121", "vgg13"])
def test_detector_parameter_count_equals_flax(F_model):
    """``--F_model``: the dropout detectors (the ensemble's one shared
    body) and a classifier name, built with two classes at the dataset's
    size."""
    from combat_tpu.models.registry import get_frequency_detector as jax_detector

    from combat_tpu_torch.models import get_frequency_detector

    for dataset in ("cifar10", "celeba"):
        jcfg, cfg = _configs(dataset, F_model=F_model)
        model = get_frequency_detector(cfg)
        assert _port_count(model) == _jax_count(jax_detector(jcfg), cfg.input_height, cfg.input_channel), dataset


def test_mnist_default_parameter_count_equals_flax():
    from combat_tpu.models.registry import get_classifier as jax_classifier

    from combat_tpu_torch.models import NetC_MNIST, get_classifier

    jcfg, cfg = _configs("mnist")
    model = get_classifier(cfg)
    assert isinstance(model, NetC_MNIST)
    assert _port_count(model) == _jax_count(jax_classifier(jcfg), 28, 1) == 628202


# --------------------------------------------------------------------------
# Forwards at narrow widths, through from_jax_params
# --------------------------------------------------------------------------


def _variables(jax_model, x, seed=0):
    """The JAX model's variables as numpy, with BatchNorm statistics made
    non-trivial so the conversion of each is tested."""
    variables = to_numpy_tree(jax.jit(jax_model.init)(jax.random.key(seed), jnp.asarray(x)))
    rng = np.random.default_rng(seed)
    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree.map(
            lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"])
    return variables


def _hold(jax_model, port, x, convert, map_out: bool = False):
    """Eval logits, then train-mode logits and the updated statistics, of
    ``port`` loaded with ``convert(variables)`` against the JAX model."""
    variables = _variables(jax_model, x)
    sd = convert(variables)
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd)
    out = (lambda t: nhwc(t)) if map_out else (lambda t: t.detach().numpy())
    ref = np.asarray(jax.jit(lambda v, a: jax_model.apply(v, a, train=False))(variables, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(out(port.eval()(nchw(x))), ref, **TOL)
    if "batch_stats" not in variables:
        return
    ref, mut = jax.jit(lambda v, a: jax_model.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(out(port.train()(nchw(x))), np.asarray(ref), **TOL)
    updated = convert({"params": variables["params"], "batch_stats": to_numpy_tree(mut["batch_stats"])})
    assert_state_close(port.state_dict(), updated, atol=1e-4, rtol=1e-4)


def _x(h, n=4, c=3, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, h, h, c)).astype(np.float32)


def _kind(kind):
    return lambda variables: from_jax_params(variables, kind)


def test_preact_bottleneck_matches_jax():
    """PreActResNet with PreActBottlenecks (one a stage; the head reads
    2048 channels), as preact_resnet50-152 build it."""
    from combat_tpu.models.preact_resnet import PreActResNet as JaxPreAct

    from combat_tpu_torch.models import PreActResNet

    _hold(JaxPreAct([1, 1, 1, 1], 10, bottleneck=True), PreActResNet((1, 1, 1, 1), 10, bottleneck=True),
          _x(32), _kind("preactresnet"))


def test_preact_depths_are_the_jax_depths():
    from combat_tpu.models import preact_resnet as J

    from combat_tpu_torch.models import preact_resnet as P

    for depth in (10, 18, 34, 50, 101, 152):
        jax_model, port = getattr(J, f"preact_resnet{depth}")(10), getattr(P, f"preact_resnet{depth}")(10)
        assert _port_count(port) == _jax_count(jax_model, 32, 3), depth


@pytest.mark.parametrize("h", [32, 64])
def test_vgg_matches_jax(h):
    """A short VGG ``cfg``; at 64 px the head reads a 2x2 map."""
    from combat_tpu.models.vgg import VGG as JaxVGG

    from combat_tpu_torch.models import VGG

    cfg = (8, "M", 16, 16, "M", 16, "M", 24, "M", 24, "M")
    _hold(JaxVGG(cfg, 10), VGG(cfg, 10, input_size=h), _x(h), _kind("vgg"))


@pytest.mark.parametrize("h", [32, 64])
def test_densenet_matches_jax(h):
    """``DenseNet(nblocks, growth_rate)``: the ``[out, x]`` concatenation
    order, the transitions; at 64 px the head reads a 2x2 map."""
    from combat_tpu.models.densenet import DenseNet as JaxDenseNet

    from combat_tpu_torch.models import DenseNet

    _hold(JaxDenseNet([2, 1, 2, 1], growth_rate=4, num_classes=10), DenseNet((2, 1, 2, 1), 4, num_classes=10,
          input_size=h), _x(h), _kind("densenet"))


@pytest.mark.parametrize("in_planes,out_planes,stride", [(8, 16, 1), (16, 16, 1), (8, 16, 2)],
                         ids=["stride1-shortcut-conv", "stride1-identity", "stride2-no-shortcut"])
def test_mobilenetv2_block_matches_jax(in_planes, out_planes, stride):
    from combat_tpu.models.mobilenetv2 import InvertedResidual as JaxBlock

    from combat_tpu_torch.checkpoint.convert import _layers
    from combat_tpu_torch.models import InvertedResidual

    def convert(variables):
        sd = {}
        _layers(sd, "", variables["params"], variables["batch_stats"])
        return sd

    port = InvertedResidual(in_planes, out_planes, 6, stride)
    assert hasattr(port, "shortcut") == (stride == 1 and in_planes != out_planes)
    _hold(JaxBlock(out_planes, 6, stride), port, _x(8, c=in_planes), convert, map_out=True)


@pytest.mark.parametrize("h", [32, 64])
def test_mobilenetv2_matches_jax(h, monkeypatch):
    """The whole model with a short block table (the modules' own ``CFG``,
    patched on both sides): the stem, the depthwise blocks, the 1280-wide
    head conv and, at 64 px, a head that reads a 4x4 map."""
    import importlib

    from combat_tpu.models import mobilenetv2 as J

    P = importlib.import_module("combat_tpu_torch.models.mobilenetv2")  # the package exports a function by its name
    short = ((1, 8, 1, 1), (6, 16, 2, 2), (6, 24, 1, 2))
    monkeypatch.setattr(J, "CFG", short)
    monkeypatch.setattr(P, "CFG", short)
    _hold(J.MobileNetV2(10), P.MobileNetV2(10, input_size=h), _x(h), _kind("mobilenetv2"))


def test_simplevit_matches_jax():
    """Patches in ``(p1 p2 c)`` order, the sin-cos embedding, tanh GELU,
    Flax's LayerNorm epsilon."""
    from combat_tpu.models.vit import SimpleViT as JaxViT

    from combat_tpu_torch.models import SimpleViT

    kw = dict(image_size=32, patch_size=8, num_classes=10, dim=32, depth=2, heads=2, mlp_dim=64, dim_head=16)
    _hold(JaxViT(**kw), SimpleViT(**kw), _x(32), _kind("simplevit"))


def test_timm_vit_matches_jax():
    """The conv patch embedding, the CLS token, the learned position
    embedding, exact GELU."""
    from combat_tpu.models.vit import VisionTransformer as JaxViT

    from combat_tpu_torch.models import VisionTransformer

    kw = dict(image_size=32, patch_size=4, num_classes=10, dim=32, depth=2, heads=2)
    jax_model, port = JaxViT(**kw), VisionTransformer(**kw)
    _hold(jax_model, port, _x(32), _kind("vit_timm"))
    assert port.pos_embed.shape == (1, 65, 32)


def test_posemb_sincos_2d_is_the_jax_table():
    from combat_tpu.models.vit import posemb_sincos_2d as jax_posemb

    from combat_tpu_torch.models import posemb_sincos_2d

    for h, w, dim in ((4, 4, 32), (8, 8, 384), (3, 5, 8)):
        np.testing.assert_array_equal(posemb_sincos_2d(h, w, dim), jax_posemb(h, w, dim))


def test_netc_mnist_eval_matches_jax():
    """NetC_MNIST at 28 px: its head reads the flattened 4x4x64 map."""
    from combat_tpu.models.misc import NetC_MNIST as JaxNetC

    from combat_tpu_torch.models import NetC_MNIST

    _hold(JaxNetC(10), NetC_MNIST(10), _x(28, c=1), _kind("netc_mnist"))


def test_fresh_vit_init_follows_flax():
    """A fresh ViT draws Flax's defaults: lecun-normal kernels (variance
    1/fan_in, truncated at two standard deviations), zero biases, LayerNorm
    ones and zeros, a zero CLS token, ``pos_embed`` N(0, 0.02)."""
    from combat_tpu_torch.models import vitsmall

    torch.manual_seed(0)
    model = vitsmall(10, 32)
    w = model.block0.fc1.weight.detach()
    assert abs(float(w.std()) - 384**-0.5) < 0.05 * 384**-0.5
    assert float(w.abs().max()) <= 2 * 384**-0.5 / 0.87962566103423978 + 1e-6
    assert not model.block0.fc1.bias.any() and not model.cls_token.any()
    assert torch.equal(model.final_norm.weight, torch.ones(384)) and model.final_norm.eps == 1e-6
    assert abs(float(model.pos_embed.detach().std()) - 0.02) < 0.002
