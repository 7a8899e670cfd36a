"""The extended classifier zoo (``combat_tpu/models/zoo_extra.py``'s 13
``--model`` names) and the auxiliary networks of ``combat_tpu/models/misc.py``
against the JAX models.

Structure at full width without compiling: each port model's parameter
count equals the Flax model's (``jax.eval_shape`` of its ``init``) at
cifar10 (32 px), celeba (64 px), imagenet10 (224 px) and mnist (28 px, one
channel); where Flax's ``init`` raises (a pool of 8 that leaves no map at 28
px), the port's constructor raises too.  Forwards at narrow widths through
the Flax constructors' own fields (``cfg``, ``in_planes``/``out_planes``/
``num_blocks``, ``num_planes``, ``cardinality``/``bottleneck_width``; the
models whose widths are fixed at full width), loaded through
``from_jax_params``: eval-mode logits, and train-mode logits with the
updated BatchNorm statistics, at 1e-4 absolute and relative, as
``tests/test_torch_zoo_models.py`` holds its families.  Every head that
reads a map larger than 1x1 is held at 64 px (or its dataset's size) too.

Dropout: the models that have it run in train mode with Flax's masks, read
back from ``capture_intermediates`` (a ``Dropout_i`` output is zero where
its mask dropped; EfficientNet's mask is one keep per (row, channel), so
its map is reduced over H and W).  Flax draws a mask from the key, the
module's path and the shape only, so the masks of any input of the shape
are the ones a step draws.  The detector step with ``--F_model
efficientnetb0`` is held to the JAX step in float64, as
``tests/test_torch_defenses_frequency.py`` holds its detectors.
"""

import contextlib
import re
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from _torch_helpers import assert_state_close, nchw, nhwc, to_numpy_tree
from combat_tpu_torch.checkpoint import convert as convert_module
from combat_tpu_torch.checkpoint import from_jax_params

TOL = dict(atol=1e-4, rtol=1e-4)
NAMES = ("lenet", "mobilenet", "efficientnetb0", "googlenet", "dpn26", "dpn92", "senet18", "shufflenetg2",
         "shufflenetv2", "resnext29_2x64d", "resnext29_32x4d", "pnasneta", "pnasnetb")
DATASETS = ("cifar10", "celeba", "imagenet10", "mnist")
# the names whose pool of 8 leaves no map of mnist's 7 x 7: Flax's init raises ZeroDivisionError
EMPTY_AT_MNIST = {"googlenet", "resnext29_2x64d", "resnext29_32x4d", "pnasneta", "pnasnetb"}
MISC = ("AE", "NetC_GTRSB", "NetC_MNIST2", "NetC_MNIST3", "NetC_CelebA")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _quick_compiles():
    """XLA compiles the JAX references with most optimizations off (their
    compiles are most of this file's time), and as before after it."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


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
def test_zoo_extra_parameter_count_equals_flax(name):
    """``--model name`` at every dataset size: Flax's count, or a
    ``ValueError`` at build where Flax's init raises."""
    from combat_tpu.models.registry import get_classifier as jax_classifier

    from combat_tpu_torch.models import get_classifier

    for dataset in DATASETS:
        jcfg, cfg = _configs(dataset, model=name)
        h, c = cfg.input_height, cfg.input_channel
        if dataset == "mnist" and name in EMPTY_AT_MNIST:
            with pytest.raises(ZeroDivisionError):
                _jax_count(jax_classifier(jcfg), h, c)
            with pytest.raises(ValueError, match="leaves nothing of a 7 x 7 map"):
                get_classifier(cfg)
            continue
        assert _port_count(get_classifier(cfg)) == _jax_count(jax_classifier(jcfg), h, c), dataset


@pytest.mark.parametrize("name", NAMES)
def test_zoo_extra_detector_parameter_count_equals_flax(name):
    """``--F_model name``: the classifier with two classes."""
    from combat_tpu.models.registry import get_frequency_detector as jax_detector

    from combat_tpu_torch.models import get_frequency_detector

    jcfg, cfg = _configs("cifar10", F_model=name)
    model = get_frequency_detector(cfg)
    assert (model.fc3 if name == "lenet" else model.linear).out_features == 2
    assert _port_count(model) == _jax_count(jax_detector(jcfg), 32, 3)


@pytest.mark.parametrize("name", MISC)
def test_misc_parameter_count_equals_flax(name):
    """The auxiliary networks at every dataset size (Flax sizes their linears
    from the map, so each builds at all four)."""
    from combat_tpu.models import misc as J

    from combat_tpu_torch.models import misc as P

    for dataset in DATASETS:
        _, cfg = _configs(dataset)
        h, c = cfg.input_height, cfg.input_channel
        port = P.AE(c) if name == "AE" else getattr(P, name)(input_size=h, in_channels=c)
        assert _port_count(port) == _jax_count(getattr(J, name)(), h, c), dataset


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


def _numbers(path):
    return tuple(tuple(int(v) for v in re.findall(r"\d+", p)) for p in path)


def dropout_masks(intermediates, broadcast: bool = False):
    """Flax's keep masks (NCHW or (N, F) bool tensors) from the captured
    ``Dropout_i`` outputs, in call order: by block index, then by dropout
    index (a name sort would put ``block10`` before ``block2``).
    ``broadcast``: one keep per (row, channel), reduced to (N, C, 1, 1)."""
    flat = traverse_util.flatten_dict(intermediates)
    calls = sorted((path[:-1] for path in flat if len(path) > 1 and path[-2].startswith("Dropout_")), key=_numbers)
    masks = []
    for path in calls:
        (value,) = flat[path + ("__call__",)]
        m = np.asarray(value) != 0
        if broadcast:
            m = m.any(axis=(1, 2), keepdims=True)
        masks.append(torch.from_numpy(np.ascontiguousarray(m.transpose(0, 3, 1, 2) if m.ndim == 4 else m)))
    return masks


def _hold(jax_model, port, x, kind, map_out=False, broadcast=False, x64=False):
    """Eval logits, then train-mode logits (with Flax's dropout masks) and
    the updated statistics, of ``port`` loaded with ``from_jax_params``
    against the JAX model.  ``x64``: both sides in float64, for a model whose
    float32 train-mode forward lies 1e-4 from its own float64 result."""
    variables = _variables(jax_model, x)
    with contextlib.ExitStack() as stack:
        if x64:
            stack.enter_context(jax.enable_x64(True))
            f64 = lambda a: torch.tensor(np.asarray(a, np.float64))  # noqa: E731
            stack.enter_context(mock.patch.object(convert_module, "_t", f64))
            variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
            x = np.asarray(x, np.float64)
            port = port.double()
        sd = from_jax_params(variables, kind)
        assert set(sd) == set(port.state_dict())
        port.load_state_dict(sd)
        xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
        out = nhwc if map_out else (lambda t: t.detach().numpy())
        ref = np.asarray(jax.jit(lambda v, a: jax_model.apply(v, a, train=False))(variables, jnp.asarray(x)))
        with torch.no_grad():
            np.testing.assert_allclose(out(port.eval()(xt)), ref, **TOL)
        if "batch_stats" not in variables:
            return None
        train = partial(jax_model.apply, train=True, mutable=["batch_stats", "intermediates"],
                        capture_intermediates=True, rngs={"dropout": jax.random.key(5)})
        ref, state = jax.jit(train)(variables, jnp.asarray(x))
        masks = dropout_masks(state["intermediates"], broadcast)
        with torch.no_grad():
            got = port.train()(xt, masks) if masks else port.train()(xt)
        np.testing.assert_allclose(out(got), np.asarray(ref), **TOL)
        updated = from_jax_params({"params": variables["params"], "batch_stats": to_numpy_tree(state["batch_stats"])},
                                  kind)
        assert_state_close(port.state_dict(), updated, atol=1e-4, rtol=1e-4)
    return masks


def _x(h, n=4, c=3, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, h, h, c)).astype(np.float32)


def test_channel_shuffle_is_the_jax_shuffle():
    from combat_tpu.models.zoo_extra import channel_shuffle as jax_shuffle

    from combat_tpu_torch.models import channel_shuffle

    x = _x(3, n=2, c=12)
    for g in (1, 2, 3, 4):
        np.testing.assert_array_equal(nhwc(channel_shuffle(nchw(x), g)), np.asarray(jax_shuffle(jnp.asarray(x), g)))


@pytest.mark.parametrize("h", [32, 64])
def test_lenet_matches_jax(h):
    """LeNet's float32 convolutions; its head reads 5 x 5 x 16 at 32 px."""
    from combat_tpu.models.zoo_extra import LeNet as J

    from combat_tpu_torch.models import LeNet

    _hold(J(10), LeNet(10, h), _x(h), "lenet")


_MOBILENET = (16, (32, 2), 32, (48, 2), (64, 2))


@pytest.mark.parametrize("h", [32, 64])
def test_mobilenet_matches_jax(h):
    """A short ``cfg``: depthwise blocks at strides 1 and 2; the head reads
    a 2x2 map at 32 px and 4x4 at 64."""
    from combat_tpu.models.zoo_extra import MobileNetV1 as J

    from combat_tpu_torch.models import MobileNetV1

    _hold(J(10, cfg=_MOBILENET), MobileNetV1(10, h, cfg=_MOBILENET), _x(h), "mobilenet")


# a short table: a widening shortcut conv, a depthwise 5x5 at stride 2 and an identity shortcut
EFFICIENTNET = ((1, 8, 1, 3, 1), (6, 12, 2, 5, 2), (6, 16, 1, 3, 2))


def test_efficientnet_matches_jax_with_its_dropout_masks():
    """Eval mode runs no dropout; train mode with Flax's broadcast masks,
    one (N, C, 1, 1) keep a block, which the port draws in that shape."""
    from combat_tpu.models.zoo_extra import EfficientNetB0 as J

    from combat_tpu_torch.models import EfficientNetB0

    port = EfficientNetB0(10, 32, cfg=EFFICIENTNET)
    masks = _hold(J(10, cfg=EFFICIENTNET), port, _x(32), "efficientnet", broadcast=True)
    assert [tuple(m.shape) for m in masks] == port.mask_shapes(4) == [(4, 8, 1, 1), (4, 12, 1, 1), (4, 12, 1, 1),
                                                                      (4, 16, 1, 1)]
    assert 0.6 < float(torch.cat([m.reshape(-1) for m in masks]).float().mean()) <= 1.0  # keep 0.8
    drawn = port.draw_masks(4, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(m.shape) for m in drawn] == port.mask_shapes(4)
    x = nchw(_x(32))
    with torch.no_grad():
        a = port(x, generator=torch.Generator().manual_seed(0))
        b = port(x, generator=torch.Generator().manual_seed(1))
        assert torch.equal(a, port(x, drawn)) and not torch.equal(a, b)


def test_efficientnet_masks_are_ordered_by_block_index():
    """Thirteen blocks of distinct widths: Flax names them ``block0``-
    ``block12``, and ``block10`` sorts before ``block2`` by name; the masks
    go by index, as the port's blocks do."""
    from combat_tpu.models.zoo_extra import EfficientNetB0 as J

    from combat_tpu_torch.models import EfficientNetB0

    cfg = tuple((1, 8 + i, 1, 3, 1) for i in range(13))
    x = jnp.asarray(_x(4, n=2))
    jm = J(10, cfg=cfg)
    variables = jax.jit(jm.init)(jax.random.key(0), x)
    _, state = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats", "intermediates"],
                                             capture_intermediates=True, rngs={"dropout": jax.random.key(1)}))(
        variables, x)
    masks = dropout_masks(state["intermediates"], broadcast=True)
    assert [tuple(m.shape) for m in masks] == EfficientNetB0(10, 4, cfg=cfg).mask_shapes(2)
    assert [m.shape[1] for m in masks] == list(range(8, 21))


def test_googlenet_matches_jax():
    """GoogLeNet at full width (its Inception widths are fixed), bs 2, 64 px:
    every convolution float32 with bias, the 3x3 max pools with padding 1,
    the head on a 2x2 map."""
    from combat_tpu.models.zoo_extra import GoogLeNet as J

    from combat_tpu_torch.models import GoogLeNet

    _hold(J(10), GoogLeNet(10, 64), _x(64, n=2), "googlenet")


_DPN = dict(in_planes=(32, 32, 64, 64), out_planes=(16, 24, 32, 40), num_blocks=(1, 2, 1, 2), dense_depth=(4, 6, 8, 8))


@pytest.mark.parametrize("h", [32, 64])
def test_dpn_matches_jax(h):
    """32-group convolutions and the dense path's concatenation
    ``[sc[:d] + out[:d], sc[d:], out[d:]]``; the head reads 1x1 at 32 px,
    2x2 at 64."""
    from combat_tpu.models.zoo_extra import DPN as J

    from combat_tpu_torch.models import DPN

    port = DPN(10, h, **_DPN)
    assert port.linear.in_features == (40 + 3 * 8) * (h // 32) ** 2
    _hold(J(10, **_DPN), port, _x(h), "dpn")


def test_senet_matches_jax():
    """SENet18 at full width (its widths are fixed), bs 2, 64 px:
    pre-activation blocks scaled by squeeze-excitation, the head on a 2x2
    map."""
    from combat_tpu.models.zoo_extra import SENet18 as J

    from combat_tpu_torch.models import SENet18

    _hold(J(10), SENet18(10, 64), _x(64, n=2), "senet")


@pytest.mark.parametrize("h", [32, 64])
def test_resnext_matches_jax(h):
    from combat_tpu.models.zoo_extra import ResNeXt29 as J

    from combat_tpu_torch.models import ResNeXt29

    kw = dict(cardinality=4, bottleneck_width=2, num_blocks=(1, 1, 2))
    _hold(J(10, **kw), ResNeXt29(10, h, **kw), _x(h), "resnext")


_SHUFFLE = dict(out_planes=(48, 96, 192), num_blocks=(2, 1, 2), groups=2)


@pytest.mark.parametrize("h", [32, 36, 64])
def test_shufflenetg2_matches_jax(h):
    """Grouped 1x1s, one group on the 24-channel stem, channel shuffles, and
    the stride-2 blocks' padded 3x3 average pool, whose mean counts the
    padding in both packages (36 px: a 9 x 9 map pooled to 5 x 5)."""
    from combat_tpu.models.zoo_extra import ShuffleNetG2 as J

    from combat_tpu_torch.models import ShuffleNetG2

    port = ShuffleNetG2(10, h, **_SHUFFLE)
    assert port.s0_0.g == 1 and port.s0_1.g == 2
    _hold(J(10, **_SHUFFLE), port, _x(h), "shufflenet")


@pytest.mark.parametrize("h", [32, 64])
def test_shufflenetv2_matches_jax(h):
    from combat_tpu.models.zoo_extra import ShuffleNetV2 as J

    from combat_tpu_torch.models import ShuffleNetV2

    kw = dict(out_channels=(16, 32, 64, 128), num_blocks=(1, 2, 1))
    _hold(J(10, **kw), ShuffleNetV2(10, h, **kw), _x(h), "shufflenetv2")


@pytest.mark.parametrize("cell,h", [("A", 64), ("B", 32)])
def test_pnasnet_matches_jax(cell, h):
    """20 cells at ``num_planes`` 8: convolutions grouped by their input,
    the stride-2 cells' 1x1 convolution of the pool.  In float64: the JAX
    model's own float32 train-mode logits lie 1.0e-4 from its float64 ones
    (BatchNorm on 4 rows, 20 cells deep), the port's float64 logits 1.5e-13."""
    from combat_tpu.models.zoo_extra import PNASNet as J

    from combat_tpu_torch.models import PNASNet

    _hold(J(10, cell=cell, num_planes=8), PNASNet(10, h, cell=cell, num_planes=8), _x(h), "pnasnet",
          x64=True)


def test_ae_matches_jax():
    """The encoder and the transposed-convolution decoder (Flax's unflipped
    kernel, flipped by the converter), BatchNorm momentum 0.05, the +-0.5
    normalization of the output."""
    from combat_tpu.models.misc import AE as J

    from combat_tpu_torch.models import AE

    _hold(J(), AE(3), _x(32), "ae", map_out=True)


def test_conv_transpose_needs_the_flip():
    """An unflipped kernel would not do: Flax's ``ConvTranspose`` differs
    from torch's on the same (transposed) weight."""
    import flax.linen as fnn

    x = _x(4, n=1, c=2)
    conv = fnn.ConvTranspose(3, (4, 4), strides=(2, 2), padding="SAME")
    variables = to_numpy_tree(conv.init(jax.random.key(0), jnp.asarray(x)))
    ref = np.asarray(conv.apply(variables, jnp.asarray(x)))
    k = variables["params"]["kernel"]
    for flip, equal in ((False, False), (True, True)):
        w = np.transpose(k, (2, 3, 0, 1))
        w = np.ascontiguousarray(w[:, :, ::-1, ::-1] if flip else w)
        got = torch.nn.functional.conv_transpose2d(nchw(x), torch.from_numpy(w),
                                                   torch.tensor(variables["params"]["bias"]), stride=2, padding=1)
        assert np.allclose(nhwc(got), ref, atol=1e-5) == equal


@pytest.mark.parametrize("name,h,c", [("NetC_GTRSB", 32, 3), ("NetC_MNIST2", 28, 1), ("NetC_MNIST3", 28, 1),
                                      ("NetC_CelebA", 64, 3)])
def test_netc_matches_jax_with_its_dropout_masks(name, h, c):
    """Each classifier at its dataset's size (every head reads a map larger
    than 1x1), train mode with Flax's masks in the shapes the port lists."""
    from combat_tpu.models import misc as J

    from combat_tpu_torch.models import misc as P

    port = getattr(P, name)(input_size=h, in_channels=c)
    kind = {"NetC_GTRSB": "netc_gtsrb", "NetC_MNIST2": "netc_mnist2", "NetC_MNIST3": "netc_mnist3",
            "NetC_CelebA": "netc_celeba"}[name]
    masks = _hold(getattr(J, name)(), port, _x(h, c=c), kind)
    assert [tuple(m.shape) for m in masks] == port.mask_shapes(4)
    assert [tuple(m.shape) for m in port.draw_masks(4, torch.Generator().manual_seed(0), "cpu")] == port.mask_shapes(4)


def test_conv2dblock_bn_momentum_is_flax_0_95():
    from combat_tpu_torch.models import BatchNorm2d, Conv2dBlock

    assert Conv2dBlock(3, 8).bn.momentum == 0.05 and BatchNorm2d(8).momentum == 0.1


# --------------------------------------------------------------------------
# --F_model efficientnetb0: the detector step against the JAX step
# --------------------------------------------------------------------------


def test_efficientnet_detector_train_step_matches_jax():
    """One ``frequency_train`` step of an EfficientNet detector (the short
    table, two classes, Adam): the JAX step in float64 with its dropout
    masks (from ``split(key)[1]``) injected into the port's step, also in
    float64, the cross-entropy of both too.  (Adam moves a parameter whose
    gradient is near its epsilon by the gradient's relative error, so a
    float32 step is not held to 1e-6 here: the port's float32 step counts
    the same and stays finite.)"""
    import optax

    from combat_tpu.config import Config as JaxConfig
    from combat_tpu.defenses.frequency import make_detector_train_step as jax_step
    from combat_tpu.defenses.frequency_train import detector_optimizer as jax_optimizer
    from combat_tpu.models.zoo_extra import EfficientNetB0 as J
    from combat_tpu.train import TrainState

    from combat_tpu_torch.models import EfficientNetB0
    from test_torch_defenses_frequency import F64_TOL, FLOAT_DRAWS, H, N, _images01, _port_step, _step_draws

    def convert(v, dtype):
        with mock.patch.object(convert_module, "_t", lambda a: torch.tensor(np.asarray(a, dtype))):
            return from_jax_params(to_numpy_tree(v), "efficientnet")

    jm, port = J(2, cfg=EFFICIENTNET), EfficientNetB0(2, H, cfg=EFFICIENTNET)
    variables = jm.init(jax.random.key(3), jnp.zeros((1, H, H, 3)))
    port.load_state_dict(convert(variables, np.float32))
    x01 = _images01(7)
    key = jax.random.key(9)
    # Adam's first step is lr x g / (|g| + 1e-8): a parameter whose gradient is
    # ~1e-8 moves with the gradient's relative error, which both packages'
    # float32 cross-entropy makes ~1e-7; here the loss keeps the logits' float64
    ce64 = mock.patch("combat_tpu.train.steps.cross_entropy", lambda logits, labels: (
        optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()))
    with jax.enable_x64(True), ce64:
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        tx = jax_optimizer(JaxConfig(F_model="efficientnetb0"))
        state = TrainState.create(apply_fn=jm.apply, params=v64["params"], tx=tx, batch_stats=v64["batch_stats"])
        new_state, m_ref = jax.jit(jax_step(jm, tx))(state, (jnp.asarray(x01, jnp.float64), jnp.zeros((N,), jnp.int32)),
                                                      key)
        corr = _step_draws(key, x01, np.float64)
        feats = jnp.asarray(np.random.default_rng(0).normal(size=(2 * N, H, H, 3)))  # any input of the step's shape
        _, st = jm.apply(v64, feats, train=True, mutable=["batch_stats", "intermediates"], capture_intermediates=True,
                         rngs={"dropout": jax.random.split(key)[1]})
        drop = dropout_masks(st["intermediates"], broadcast=True)
        ref_sd = convert({"params": new_state.params, "batch_stats": new_state.batch_stats}, np.float64)
        m_ref = {k: float(v) for k, v in m_ref.items()}
    assert [tuple(t.shape) for t in drop] == port.mask_shapes(2 * N)
    assert not all(bool(t.all()) for t in drop)  # some channels dropped

    with mock.patch("combat_tpu_torch.defenses.frequency.cross_entropy",
                    lambda logits, y: torch.nn.functional.cross_entropy(logits, y.long())):
        sd64, m = _port_step(port, "efficientnetb0", x01, (corr, drop), torch.float64)
    assert float(m["sample"]) == m_ref["sample"] == 2 * N
    np.testing.assert_allclose(float(m["loss_ce"]), m_ref["loss_ce"], **F64_TOL)
    assert float(m["correct"]) == m_ref["correct"]
    assert_state_close(sd64, ref_sd, **F64_TOL)

    corr32 = corr._replace(**{f: getattr(corr, f).float() for f in FLOAT_DRAWS})
    sd32, m32 = _port_step(port, "efficientnetb0", x01, (corr32, drop), torch.float32)
    assert float(m32["correct"]) == m_ref["correct"]
    assert all(torch.isfinite(v).all() for v in sd32.values() if v.is_floating_point())


def test_efficientnet_detector_draws_its_masks_in_train_mode_only():
    """The port's detector step draws EfficientNet's broadcast masks (its
    dropout is live in train mode); frozen in a generator stage it draws
    none, as the JAX package applies it with train=False."""
    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.defenses.frequency import draw_detector
    from combat_tpu_torch.models import get_frequency_detector
    from combat_tpu_torch.train import draw_drop_F, freeze

    netF = get_frequency_detector(apply_dataset_preset(Config(F_model="efficientnetb0")))
    x01 = torch.rand((4, 3, 32, 32))
    drawn = draw_detector(netF.train(), x01, torch.Generator().manual_seed(0))
    assert [tuple(m.shape) for m in drawn.drop] == netF.mask_shapes(8) and len(drawn.drop) == 16
    assert draw_drop_F(freeze(netF), 4, torch.Generator(), "cpu") is None
