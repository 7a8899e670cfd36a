"""The port's models, loaded with ``from_jax_params`` from the JAX package's
initialised weights, against the JAX models on the same inputs.

Small widths: PreActResNet with one block per stage, UNet with nf=8.
Tolerances: logits pass through ~10-20 float32 convolutions whose
summation order differs between XLA and PyTorch, so 1e-4 absolute (plus
1e-4 relative) on O(1) outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import assert_state_close, nchw, to_numpy_tree
from combat_tpu_torch.checkpoint import from_jax_params
from combat_tpu_torch.models import FrequencyModel, PreActResNet, ResNet, UnetGenerator, guided_relu

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(kind, seed=0):
    """(jax module, jax variables as numpy, port module) with the port
    loaded from the converted JAX weights."""
    from combat_tpu.models.frequency import FrequencyModel as JaxFrequency
    from combat_tpu.models.generators import UnetGenerator as JaxUnet
    from combat_tpu.models.preact_resnet import PreActResNet as JaxPreAct
    from combat_tpu.models.resnet import ResNet as JaxResNet

    jax_model, port = {
        "preactresnet18": (JaxPreAct([1, 1, 1, 1], 10), PreActResNet((1, 1, 1, 1), 10)),
        "resnet": (JaxResNet([1, 1, 1, 1], 10), ResNet((1, 1, 1, 1), 10)),
        "unet": (JaxUnet(nf=8), UnetGenerator(nf=8)),
        "frequency": (JaxFrequency(num_classes=2), FrequencyModel(num_classes=2)),
    }[kind]
    variables = to_numpy_tree(jax_model.init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3))))
    # make the BN statistics non-trivial so the conversion of each is tested
    rng = np.random.default_rng(seed)
    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree.map(
            lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.ndim else a).astype(np.float32), variables["batch_stats"]
        )
    port.load_state_dict(from_jax_params(variables, kind))
    return jax_model, variables, port


def _x(seed, n=4, scale=1.0):
    return (np.random.default_rng(seed).uniform(-1, 1, (n, 32, 32, 3)) * scale).astype(np.float32)


@pytest.mark.parametrize("kind", ["preactresnet18", "unet", "frequency"])
def test_eval_outputs_match_jax(kind):
    jax_model, variables, port = _pair(kind)
    x = _x(1, scale=100.0 if kind == "frequency" else 1.0)  # the detector sees DCT coefficients
    ref = np.asarray(jax_model.apply(variables, jnp.asarray(x), train=False))
    got = port.eval()(nchw(x)).detach().numpy()
    if kind == "unet":
        got = got.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("kind", ["preactresnet18", "frequency"])
def test_train_mode_bn_update_matches_jax(kind):
    """Train-mode logits and the updated running statistics.  The port's BN
    takes the biased batch variance, as Flax does (models/layers.py:119-123),
    so the statistics agree to float32 rounding."""
    jax_model, variables, port = _pair(kind, seed=2)
    x = _x(3, n=8, scale=100.0 if kind == "frequency" else 1.0)
    rngs = {"dropout": jax.random.key(0)}
    ref, mut = jax_model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"], rngs=rngs)
    port.train()
    if kind == "frequency":  # dropout draws cannot be shared: compare the BN path only
        port.dropout.p = 0.0
        ref, mut = jax_model.clone(dropout=0.0).apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = port(nchw(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    updated = from_jax_params({"params": variables["params"], "batch_stats": to_numpy_tree(mut["batch_stats"])}, kind)
    assert_state_close(port.state_dict(), updated, atol=1e-4, rtol=1e-4)


def test_conversion_covers_every_port_tensor():
    for kind in ("preactresnet18", "resnet", "unet", "frequency"):
        _, variables, port = _pair(kind)
        assert set(from_jax_params(variables, kind)) == set(port.state_dict())
    with pytest.raises(ValueError):
        from_jax_params({"params": {}}, "vgg")


def test_frequency_head_flatten_is_permuted():
    """The JAX head reads an (H, W, C)-flattened map, the port's a
    (C, H, W)-flattened one: the converted kernel must be permuted, not just
    transposed."""
    _, variables, port = _pair("frequency")
    k = variables["params"]["linear"]["kernel"]  # (2048, 2)
    assert not np.allclose(port.linear.weight.detach().numpy(), k.T)


def test_guided_relu_matches_jax():
    from combat_tpu.models.layers import guided_relu as jax_guided

    rng = np.random.default_rng(0)
    x, g = rng.standard_normal((2, 5)).astype(np.float32), rng.standard_normal((2, 5)).astype(np.float32)
    out, vjp = jax.vjp(jax_guided, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = guided_relu(xt)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


def test_preact_hooks():
    _, _, port = _pair("preactresnet18")
    x = nchw(_x(4))
    port.eval()
    logits, feats = port(x, capture_features=True)
    assert set(feats) == {"layer1", "layer2", "layer3", "layer4"} and feats["layer4"].shape == (4, 512, 4, 4)
    torch.testing.assert_close(port(x, channel_mask=torch.ones(512)), logits)
    perturbed = port(x, feature_perturb={"layer4": torch.ones_like(feats["layer4"])})
    assert not torch.allclose(perturbed, logits)


def test_registry_raises_for_later_slices():
    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator

    cfg = apply_dataset_preset(Config())
    assert isinstance(get_classifier(cfg), PreActResNet)
    assert isinstance(get_generator(cfg), UnetGenerator)
    assert isinstance(get_frequency_detector(cfg), FrequencyModel)
    for make in (
        lambda: get_classifier(cfg.replace(model="vgg16")),
        lambda: get_classifier(cfg.replace(model="mobilenetv2")),
        lambda: get_classifier(apply_dataset_preset(Config(dataset="mnist"))),
        lambda: get_frequency_detector(cfg.replace(F_model="original_dropout")),
    ):
        with pytest.raises(NotImplementedError, match="later slice"):
            make()


@pytest.mark.parametrize("dataset", ["celeba", "mnist"])
def test_named_preactresnet18_builds_for_any_dataset(dataset):
    """``--model preactresnet18`` builds for any dataset, as the JAX registry
    does: celeba (64 px, 3 channels, 8 classes; a pooled 2x2 map, so the
    head's flatten permutation is exercised) and mnist (28 px, 1 channel).
    The port, loaded from the JAX model's weights, gives its logits."""
    from combat_tpu.config import Config as JaxConfig
    from combat_tpu.config import apply_dataset_preset as jax_preset
    from combat_tpu.models.registry import get_classifier as jax_classifier

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier

    cfg = apply_dataset_preset(Config(dataset=dataset, model="preactresnet18"))
    jax_model = jax_classifier(jax_preset(JaxConfig(dataset=dataset, model="preactresnet18")))
    h, c = cfg.input_height, cfg.input_channel
    variables = to_numpy_tree(jax_model.init(jax.random.key(0), jnp.zeros((1, h, h, c))))
    port = get_classifier(cfg)
    assert port.conv1.in_channels == c and port.linear.out_features == cfg.num_classes
    port.load_state_dict(from_jax_params(variables, "preactresnet18"))
    x = np.random.default_rng(5).uniform(-1, 1, (2, h, h, c)).astype(np.float32)
    ref = np.asarray(jax_model.apply(variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(port.eval()(nchw(x)).detach().numpy(), ref, **TOL)
