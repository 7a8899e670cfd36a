"""The port's ResNet (combat_tpu_torch/models/resnet.py) against the JAX
package's, loaded with ``from_jax_params(..., "resnet")`` from the JAX
model's initialised weights, and the registry that builds it.

At 64 px the pooled map is 2x2 (512 or 2048 channels), so the head's
flatten permutation is exercised; at 32 px it is 1x1 and would hide a
missing permutation.  Tolerance 1e-4 absolute plus 1e-4 relative, as
tests/test_torch_models.py holds the other models: ~20-50 float32
convolutions in another summation order on O(1) outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import assert_state_close, nchw, to_numpy_tree
from combat_tpu_torch.checkpoint import from_jax_params
from combat_tpu_torch.models import ResNet, resnet18, resnet50

TOL = dict(atol=1e-4, rtol=1e-4)
SIZE = 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(name, seed=0, num_classes=10):
    """(jax module, jax variables as numpy, port module) at 64 px, the port
    loaded from the converted JAX weights; BN statistics made non-trivial so
    the conversion of each is tested."""
    from combat_tpu.models import resnet as jax_resnet

    jax_model = getattr(jax_resnet, name)(num_classes)
    port = {"resnet18": resnet18, "resnet50": resnet50}[name](num_classes, SIZE)
    variables = to_numpy_tree(jax_model.init(jax.random.key(seed), jnp.zeros((1, SIZE, SIZE, 3))))
    rng = np.random.default_rng(seed)
    variables["batch_stats"] = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"]
    )
    port.load_state_dict(from_jax_params(variables, "resnet"))
    return jax_model, variables, port


def _x(seed, n=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_eval_logits_match_jax(name):
    jax_model, variables, port = _pair(name)
    x = _x(1)
    ref = np.asarray(jax_model.apply(variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(port.eval()(nchw(x)).detach().numpy(), ref, **TOL)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_train_mode_logits_and_bn_update_match_jax(name):
    """Train-mode logits and every updated running statistic (the port's BN
    takes the biased batch variance, as Flax does)."""
    jax_model, variables, port = _pair(name, seed=2)
    x = _x(3)
    ref, mut = jax_model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = port.train()(nchw(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    updated = from_jax_params({"params": variables["params"], "batch_stats": to_numpy_tree(mut["batch_stats"])},
                              "resnet")
    assert_state_close(port.state_dict(), updated, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_conversion_covers_every_port_tensor_and_permutes_the_head(name):
    """Every tensor of the port's state_dict comes from the JAX tree, and the
    head's kernel is permuted from the (H, W, C) flatten, not only
    transposed (512 channels for BasicBlocks, 2048 for Bottlenecks)."""
    _, variables, port = _pair(name)
    assert set(from_jax_params(variables, "resnet")) == set(port.state_dict())
    k = variables["params"]["linear"]["kernel"]
    assert k.shape == (port.linear.in_features, 10) == ((512 if name == "resnet18" else 2048) * 4, 10)
    assert not np.allclose(port.linear.weight.detach().numpy(), k.T)


def test_resnet18_parameter_count_at_celeba():
    """PARITY.md's count for the reference's ResNet18 at celeba (64 px, 8
    classes), and the JAX model's."""
    from combat_tpu.config import Config as JaxConfig
    from combat_tpu.config import apply_dataset_preset as jax_preset
    from combat_tpu.models.registry import get_classifier as jax_classifier

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier

    port = get_classifier(apply_dataset_preset(Config(dataset="celeba")))
    n_port = sum(p.numel() for p in port.parameters())
    variables = jax_classifier(jax_preset(JaxConfig(dataset="celeba"))).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3))
    )
    assert n_port == 11_185_224 == sum(np.size(a) for a in jax.tree.leaves(variables["params"]))


def test_resnet_hooks():
    _, _, port = _pair("resnet18")
    x = nchw(_x(4))
    port.eval()
    logits, feats = port(x, capture_features=True)
    assert set(feats) == {"layer1", "layer2", "layer3", "layer4"} and feats["layer4"].shape == (2, 512, 8, 8)
    torch.testing.assert_close(port(x, channel_mask=torch.ones(512)), logits)
    perturbed = port(x, feature_perturb={"layer4": torch.ones_like(feats["layer4"])})
    assert not torch.allclose(perturbed, logits)


@pytest.mark.parametrize(
    "dataset,model,blocks",
    [("celeba", "default", (2, 2, 2, 2)), ("imagenet10", "default", (2, 2, 2, 2)),
     ("cifar10", "resnet18", (2, 2, 2, 2)), ("celeba", "resnet34", (3, 4, 6, 3))],
)
def test_registry_builds_resnets(dataset, model, blocks):
    """celeba's and imagenet10's default classifier is ResNet18, and
    ``--model resnet18`` / ``resnet34`` build for any dataset, each with the
    JAX registry's parameter count and a head sized from the pooled map (7x7
    at 224 px)."""
    from combat_tpu.config import Config as JaxConfig
    from combat_tpu.config import apply_dataset_preset as jax_preset
    from combat_tpu.models.registry import get_classifier as jax_classifier

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier

    cfg = apply_dataset_preset(Config(dataset=dataset, model=model))
    port = get_classifier(cfg)
    assert isinstance(port, ResNet)
    assert tuple(len(getattr(port, f"layer{s}")) for s in range(1, 5)) == blocks
    side = {32: 1, 64: 2, 224: 7}[cfg.input_height]
    assert port.linear.in_features == 512 * side * side and port.linear.out_features == cfg.num_classes
    h = cfg.input_height
    shapes = jax.eval_shape(
        lambda: jax_classifier(jax_preset(JaxConfig(dataset=dataset, model=model))).init(
            jax.random.key(0), jnp.zeros((1, h, h, 3))
        )
    )
    assert sum(p.numel() for p in port.parameters()) == sum(np.prod(a.shape) for a in jax.tree.leaves(shapes["params"]))
