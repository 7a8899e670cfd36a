"""The detectors whose dropout stays live in eval mode (``--F_model
original_dropout``, ``original_dropout_ensemble``), NetC_MNIST's train-mode
dropout, and the two places where mnist stops in both packages.

Dropout masks cannot be reproduced across frameworks, so the Flax masks are
read back from ``capture_intermediates`` (a ``Dropout_i`` output is zero
exactly where its mask dropped the element) and injected into the port.
Flax draws a mask from the ``dropout`` key and the module's path and call
count only, so the masks a step draws from its key are those an ``apply``
of the same detector draws from that key on any input of the step's shape.
Tolerances: logits 1e-4 as ``tests/test_torch_models.py``; the steps'
metrics as ``tests/test_torch_steps.py`` (counts exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from _torch_helpers import jax_alternated_draws, jax_sigma, nchw, to_numpy_tree
from combat_tpu_torch.checkpoint import from_jax_params
from test_torch_steps import BS, _assert_metrics, _batch, _configs, _models, _port_states

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("COMBAT_PALLAS_INTERPRET", "1")
    torch.set_num_threads(1)


def flax_masks(module, variables, x, key, train=False):
    """The keep masks (NCHW bool tensors, in call order) of every dropout
    of ``module.apply(variables, x)`` with the dropout key ``key``, and its
    output.  A submodule called more than once (the ensemble's body) has
    its outputs in call order; the masks go pass by pass."""
    mutable = ["intermediates"] + (["batch_stats"] if train and "batch_stats" in variables else [])
    out, state = module.apply(variables, jnp.asarray(x), train=train, capture_intermediates=True,
                              mutable=mutable, rngs={"dropout": key})
    flat = traverse_util.flatten_dict(state["intermediates"])
    calls = {path[:-1]: value for path, value in flat.items() if len(path) > 1 and path[-2].startswith("Dropout_")}
    scopes = sorted({p[:-1] for p in calls})
    passes = len(next(iter(calls.values())))
    masks = []
    for scope in scopes:
        names = sorted((p for p in calls if p[:-1] == scope), key=lambda p: int(p[-1].split("_")[1]))
        for i in range(passes):
            for name in names:
                m = np.asarray(calls[name][i]) != 0
                masks.append(torch.from_numpy(m.transpose(0, 3, 1, 2) if m.ndim == 4 else m))
    return masks, np.asarray(out)


def _detector(kind, seed=3, h=32):
    """(JAX module, numpy variables, port module loaded from them)."""
    from combat_tpu.models.frequency import FrequencyModelDropoutEnsemble as JaxEnsemble
    from combat_tpu.models.frequency import frequency_model_dropout as jax_dropout

    from combat_tpu_torch.models import FrequencyModelDropoutEnsemble, frequency_model_dropout

    jax_model, port, conv = {
        "original_dropout": (jax_dropout(2, 0.5), frequency_model_dropout(2, 0.5, h), "frequency"),
        "original_dropout_ensemble": (JaxEnsemble(2, 0.5, 3), FrequencyModelDropoutEnsemble(2, 0.5, 3, h),
                                      "frequency_ensemble"),
    }[kind]
    variables = to_numpy_tree(jax_model.init(jax.random.key(seed), jnp.zeros((1, h, h, 3))))
    port.load_state_dict(from_jax_params(variables, conv))
    return jax_model, variables, port


def _features(seed, n=4, h=32):
    return (np.random.default_rng(seed).uniform(-1, 1, (n, h, h, 3)) * 100).astype(np.float32)


@pytest.mark.parametrize("kind", ["original_dropout", "original_dropout_ensemble"])
def test_live_dropout_detector_matches_flax_with_its_masks(kind):
    """In eval mode, after ``freeze``, with Flax's masks: Flax's logits."""
    from combat_tpu_torch.train import freeze

    jax_model, variables, port = _detector(kind)
    x = _features(1)
    masks, ref = flax_masks(jax_model, variables, x, jax.random.key(7))
    assert len(masks) == len(port.mask_shapes(4)) == (9 if kind.endswith("ensemble") else 3)
    assert [tuple(m.shape) for m in masks] == port.mask_shapes(4)
    assert 0.4 < float(torch.cat([m.reshape(-1) for m in masks]).float().mean()) < 0.6  # keep 1 - 0.5
    with torch.no_grad():
        got = freeze(port)(nchw(x), masks).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_ensemble_runs_one_shared_body_with_fresh_masks():
    """Flax's ensemble applies one ``body`` three times with three masks
    each: the port holds one body (its parameters are the body's), and the
    mean of the body's three masked passes is the ensemble's output."""
    from combat_tpu_torch.models import FrequencyModelDropoutEnsemble

    jax_model, variables, port = _detector("original_dropout_ensemble")
    assert set(variables["params"]) == {"body"}
    assert isinstance(port, FrequencyModelDropoutEnsemble) and [n for n, _ in port.named_children()] == ["body"]
    x = _features(2)
    masks, ref = flax_masks(jax_model, variables, x, jax.random.key(8))
    assert not torch.equal(masks[0], masks[3]) and not torch.equal(masks[3], masks[6])  # fresh masks a pass
    port.eval()
    with torch.no_grad():
        passes = [port.body(nchw(x), masks[3 * i:3 * i + 3]) for i in range(3)]
    np.testing.assert_allclose(torch.stack(passes, 1).mean(1).numpy(), ref, **TOL)


def test_dropout_stays_live_after_freeze():
    """``freeze`` calls ``.eval()``: the dropout detectors still draw a new
    mask a call, the ``original`` detector and a classifier detector do
    not; ``draw_drop_F`` draws only for the former."""
    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_frequency_detector, live_dropout
    from combat_tpu_torch.train import draw_drop_F, freeze

    x = torch.from_numpy(_features(3)).permute(0, 3, 1, 2).contiguous()
    for name, live in (("original_dropout", True), ("original_dropout_ensemble", True), ("original", False),
                       ("densenet121", False)):
        torch.manual_seed(0)
        netF = freeze(get_frequency_detector(apply_dataset_preset(Config(F_model=name))))
        assert live_dropout(netF) == live, name
        with torch.no_grad():
            a, b = netF(x), netF(x)
        assert torch.equal(a, b) != live, name
        gen = torch.Generator().manual_seed(1)
        drawn = draw_drop_F(netF, 4, gen, "cpu")
        assert (drawn is not None) == live, name
        assert torch.equal(gen.get_state(), torch.Generator().manual_seed(1).get_state()) != live, name


def test_draws_are_unchanged_for_a_detector_without_live_dropout():
    """The eval-live detector's masks are drawn after every other role, and
    only for it: with the ``original`` detector, or none, the generator is
    consumed exactly as before; with the ensemble, the other roles are the
    same draws."""
    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_frequency_detector
    from combat_tpu_torch.train import draw_alternated, freeze

    cfg = apply_dataset_preset(Config())
    runs = {}
    for name in (None, "original", "original_dropout_ensemble"):
        netF = None if name is None else freeze(get_frequency_detector(cfg.replace(F_model=name)))
        gen = torch.Generator().manual_seed(5)
        runs[name] = (draw_alternated(cfg, 8, gen, "cpu", netF), gen.get_state())
    for name in ("original", "original_dropout_ensemble"):
        draws, state = runs[name]
        base = runs[None][0]
        for field in base._fields[:-1]:
            a, b = getattr(draws, field), getattr(base, field)
            assert all(torch.equal(u, v) for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b))), field
        assert (draws.drop_F is None) == (name == "original")
        assert torch.equal(state, runs[None][1]) == (name == "original")
    assert len(runs["original_dropout_ensemble"][0].drop_F) == 9


def test_netc_mnist_train_mode_dropout_matches_flax():
    """NetC_MNIST runs its five dropouts in train mode with the masks it is
    given (Flax's), and from a generator otherwise; eval mode runs none."""
    from combat_tpu.models.misc import NetC_MNIST as JaxNetC

    from combat_tpu_torch.models import NetC_MNIST

    jax_model = JaxNetC(10)
    x = np.random.default_rng(4).uniform(-1, 1, (4, 28, 28, 1)).astype(np.float32)
    variables = to_numpy_tree(jax_model.init(jax.random.key(0), jnp.zeros((1, 28, 28, 1))))
    port = NetC_MNIST(10)
    port.load_state_dict(from_jax_params(variables, "netc_mnist"))
    masks, ref = flax_masks(jax_model, variables, x, jax.random.key(9), train=True)
    assert [tuple(m.shape) for m in masks] == [(4, 32, 24, 24), (4, 32, 12, 12), (4, 64, 8, 8), (4, 64, 4, 4),
                                               (4, 512)]
    port.train()
    with torch.no_grad():
        np.testing.assert_allclose(port(nchw(x), masks).numpy(), ref, **TOL)
        a = port(nchw(x), generator=torch.Generator().manual_seed(0))
        b = port(nchw(x), generator=torch.Generator().manual_seed(0))
        c = port(nchw(x), generator=torch.Generator().manual_seed(1))
        assert torch.equal(a, b) and not torch.equal(a, c)
        port.eval()
        assert torch.equal(port(nchw(x)), port(nchw(x)))


# --------------------------------------------------------------------------
# The steps with the ensemble detector, against the JAX steps
# --------------------------------------------------------------------------


def _ensemble_models():
    """``tests/test_torch_steps.py``'s models with the ensemble detector in
    place of ``original``."""
    from combat_tpu.models.frequency import FrequencyModelDropoutEnsemble as JaxEnsemble
    from combat_tpu.train import init_frozen

    from combat_tpu_torch.models import FrequencyModelDropoutEnsemble

    j, port = _models()
    j["F"] = JaxEnsemble(2, 0.5, 3)
    j["nf"] = init_frozen(j["F"], jax.random.key(3), jnp.zeros((1, 32, 32, 3)))
    port["nf"] = FrequencyModelDropoutEnsemble(2, 0.5, 3)
    port["nf"].load_state_dict(from_jax_params(to_numpy_tree(j["nf"].variables), "frequency_ensemble"))
    return j, port


def _step_masks(j, x, key):
    from combat_tpu.ops.dct import detector_features

    masks, _ = flax_masks(j["F"], to_numpy_tree(j["nf"].variables), np.asarray(detector_features(jnp.asarray(x))),
                          key)
    return masks


def test_alternated_step_with_the_ensemble_detector_matches_jax():
    """One alternated step with ``original_dropout_ensemble``: the JAX
    step's metrics, F Acc included, with its masks (from ``k[8]``) injected
    into ``drop_F``.  The trigger takes the route with no kernel on both
    sides (``tests/test_torch_steps.py`` holds every route)."""
    from combat_tpu.train import make_alternated_train_step as jax_make

    from combat_tpu_torch.train import make_alternated_train_step

    jcfg, cfg = _configs(F_model="original_dropout_ensemble", pallas_trigger=False)
    j, port = _ensemble_models()
    x, y = _batch()
    key = jax.random.key(11)
    _, _, ref = jax.jit(jax_make(jcfg, j["C"], j["G"]))(j["sC"], j["sG"], j["cm"], j["nf"], (x, y), key)

    stateC, stateG, cm, nf = _port_states(port)
    draws = jax_alternated_draws(key, cfg, BS)._replace(drop_F=_step_masks(j, x, jax.random.split(key, 10)[8]))
    got = make_alternated_train_step(cfg, port["C"], port["G"])(
        stateC, stateG, cm, nf, (nchw(x), torch.from_numpy(y).long()), draws=draws)
    _assert_metrics(got, ref)


def test_attack_eval_step_with_the_ensemble_detector_matches_jax():
    """The attack eval step with ``original_dropout_ensemble``: its masks
    from the JAX step's ``k[1]``."""
    from combat_tpu.train import make_attack_eval_step as jax_make

    from combat_tpu_torch.train import make_attack_eval_step

    jcfg, cfg = _configs(F_model="original_dropout_ensemble", pallas_trigger=False)
    j, port = _ensemble_models()
    x, y = _batch(2)
    valid = np.array([True] * 6 + [False] * 2)
    key = jax.random.key(4)
    ref = jax.jit(jax_make(jcfg, j["C"], j["G"]))(j["sC"].variables, j["sG"].params, j["cm"], j["nf"],
                                                   (x, y, valid), key)
    _, _, cm, nf = _port_states(port)
    k = jax.random.split(key, 2)
    batch = (nchw(x), torch.from_numpy(y).long(), torch.from_numpy(valid))
    got = make_attack_eval_step(cfg, port["C"], port["G"])(
        cm, nf, batch, sigma_draw=jax_sigma(k[0], cfg.sigma), drop_F=_step_masks(j, x, k[1]))
    _assert_metrics(got, ref)


# --------------------------------------------------------------------------
# mnist stops in both packages: J1 (train-mode dropout), J2 (the UNet at 28 px)
# --------------------------------------------------------------------------


def test_mnist_stops_at_the_same_two_points_in_both_packages():
    """J1: a C-step with NetC_MNIST, whose dropout is live in train mode,
    stops in the JAX package (``InvalidRngError``: no ``dropout`` rng) and
    is refused by every training step of the port
    (``NotImplementedError``).  J2: the UNet generator fails at 28 px in
    both (28 -> 14 -> 7 -> 4 -> 8 does not meet the 7 px skip)."""
    import flax

    from combat_tpu.models.generators import UnetGenerator as JaxUnet
    from combat_tpu.models.misc import NetC_MNIST as JaxNetC
    from combat_tpu.train import init_train_state, multistep_lr, sgd_torch
    from combat_tpu.train.steps import make_clean_train_step as jax_make

    from combat_tpu_torch.models import NetC_MNIST, UnetGenerator
    from combat_tpu_torch.train import make_alternated_train_step, make_clean_train_step, make_victim_train_step
    from combat_tpu_torch.train import variants

    jcfg, cfg = _configs()
    jcfg, cfg = jcfg.replace(dataset="mnist"), cfg.replace(dataset="mnist")
    x = np.zeros((2, 28, 28, 1), np.float32)
    y = np.zeros((2,), np.int32)
    C = JaxNetC(10)
    state = init_train_state(C, jax.random.key(0), jnp.asarray(x[:1]), sgd_torch(multistep_lr(0.01, (100,), 0.1, 1)))
    with pytest.raises(flax.errors.InvalidRngError, match="dropout"):
        jax_make(jcfg, C)(state, (jnp.asarray(x), jnp.asarray(y)), jax.random.key(1))
    G = UnetGenerator(in_channels=1, out_channels=1)
    for make in (lambda m: make_clean_train_step(cfg, m), lambda m: make_alternated_train_step(cfg, m, G),
                 lambda m: make_victim_train_step(cfg, m, G), lambda m: variants.make_wanet_train_step(cfg, m, G),
                 lambda m: variants.make_multilabel_train_step(cfg, m, G)):
        with pytest.raises(NotImplementedError, match="dropout"):
            make(NetC_MNIST(10))

    with pytest.raises(TypeError, match=r"incompatible shapes.*\(1, 8, 8, 128\), \(1, 7, 7, 128\)"):
        JaxUnet(out_channels=1).init(jax.random.key(0), jnp.asarray(x[:1]))
    with pytest.raises(RuntimeError, match=r"size of tensor a \(8\) must match the size of tensor b \(7\)"):
        G(nchw(x[:1]))
