"""The attack variants' eval and victim steps against the JAX package's (on
every trigger route of the additive ones), and the pair epoch and the
paired eval with injected permutations.

Sizes, tolerances and helpers are those of tests/test_torch_variants.py;
counts are compared exactly, the victim step's updated parameters to 5e-5.
The random draws are the JAX step's own: the input-aware evals' two sigmas
from ``split(key, 3)`` (attack eval) or ``split(key, 2)`` (victim eval), and
the multilabel eval's one sigma per class from ``fold_in(key, ci)``.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_helpers import assert_state_close, jax_aug_draws, jax_pair_sigmas, jax_sigma, nchw, to_numpy_tree
from combat_tpu_torch.checkpoint import from_jax_params
from test_torch_steps import BS, PARAM_TOL, _assert_metrics, _batch, _configs
from test_torch_variants import ROUTES, _port_states, _rng, _route_configs, _variant_models

VALID = np.array([True] * 5 + [False] * 3)  # a padded last batch
POISONED = np.array([True, False, True, False, True, False, False, True])


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("COMBAT_PALLAS_INTERPRET", "1")
    torch.set_num_threads(1)


def _eval_inputs(seed, pair=False, labels=None):
    """(JAX batch, port batch): x, y[, x2], valid."""
    x, y = _batch(seed)
    if labels is not None:
        y = labels
    arrays = [x, y] + ([_rng(seed + 1).uniform(-1, 1, x.shape).astype(np.float32)] if pair else []) + [VALID]
    port = [nchw(x), torch.from_numpy(y).long()] + ([nchw(arrays[2])] if pair else []) + [torch.from_numpy(VALID)]
    return tuple(arrays), tuple(port)


def _jax_eval(variant, kind, jcfg, batch, key, victim=False):
    """The JAX variant eval step's metrics, and the models it ran on."""
    import combat_tpu.train.variants as jv

    j, port = _variant_models(kind)
    name = f"make_{variant}_victim_eval_step" if victim else f"make_{variant}_eval_step"
    step = jax.jit(getattr(jv, name)(jcfg, j["C"], j["G"]))
    args = (j["sC"].variables, j["sG"].params) + (() if victim else (j["cm"], j["nf"]))
    return step(*args, batch, key), port


def test_wanet_eval_step_matches_jax():
    from combat_tpu_torch.train.variants import make_wanet_eval_step

    jcfg, cfg = _configs()
    jbatch, batch = _eval_inputs(40)
    ref, port = _jax_eval("wanet", "grid", jcfg, jbatch, jax.random.key(41))
    _, _, cm, nf = _port_states(port)
    got = make_wanet_eval_step(cfg, port["C"], port["G"])(cm, nf, batch)
    _assert_metrics(got, ref)
    assert float(got["clean_sample"]) == 5.0


@pytest.mark.parametrize("route", list(ROUTES))
def test_inputaware_eval_step_matches_jax(route):
    from combat_tpu_torch.train.variants import make_inputaware_eval_step

    jcfg, cfg = _route_configs(route)
    jbatch, batch = _eval_inputs(42, pair=True)
    key = jax.random.key(43)
    ref, port = _jax_eval("inputaware", "unet", jcfg, jbatch, key)
    _, _, cm, nf = _port_states(port)
    got = make_inputaware_eval_step(cfg, port["C"], port["G"])(cm, nf, batch, draws=jax_pair_sigmas(key, cfg, 3))
    _assert_metrics(got, ref)


@pytest.mark.parametrize("route", list(ROUTES))
def test_multilabel_eval_step_matches_jax(route):
    """Ten class passes a batch, each with its own sigma; the detector counts
    every valid row on each pass."""
    from combat_tpu_torch.train.variants import make_multilabel_eval_step

    jcfg, cfg = _route_configs(route)
    labels = _rng(44).integers(0, 10, BS).astype(np.int32)
    jbatch, batch = _eval_inputs(45, labels=labels)
    key = jax.random.key(46)
    ref, port = _jax_eval("multilabel", "cunet", jcfg, jbatch, key)
    _, _, cm, nf = _port_states(port)
    sigmas = torch.stack([jax_sigma(jax.random.fold_in(key, ci), cfg.sigma) for ci in range(cfg.num_classes)])
    got = make_multilabel_eval_step(cfg, port["C"], port["G"])(cm, nf, batch, sigma_draws=sigmas)
    _assert_metrics(got, ref)
    # every class pass counts the valid rows of the other classes
    assert float(got["bd_sample"]) == sum(float((labels[VALID] != ci).sum()) for ci in range(10))


def test_wanet_victim_train_step_matches_jax():
    import combat_tpu.train.variants as jv

    from combat_tpu_torch.train import TrainState, multistep_lr
    from combat_tpu_torch.train.variants import make_wanet_victim_train_step

    jcfg, cfg = _configs()
    j, port = _variant_models("grid")
    x, y = _batch(47)
    key = jax.random.key(48)
    sC, ref = jax.jit(jv.make_wanet_victim_train_step(jcfg, j["C"], j["G"]))(j["sC"], j["sG"].params,
                                                                            (x, y, POISONED), key)
    stateC = TrainState(port["C"], multistep_lr(0.01, (100,), 0.1, 10))
    step = make_wanet_victim_train_step(cfg, port["C"], port["G"])
    batch = (nchw(x), torch.from_numpy(y).long(), torch.from_numpy(POISONED))
    got = step(stateC, batch, draws=jax_aug_draws(jax.random.split(key, 2)[0], BS))
    _assert_metrics(got, ref)
    assert stateC.step == int(sC.step) == 1
    assert_state_close(port["C"].state_dict(), from_jax_params(to_numpy_tree(sC.variables), "preactresnet18"),
                       **PARAM_TOL)
    # G is frozen: the step leaves it as it was
    assert_state_close(port["G"].state_dict(), from_jax_params(to_numpy_tree(j["sG"].variables), "grid"), atol=0.0)


def test_wanet_victim_eval_step_matches_jax():
    from combat_tpu_torch.train.variants import make_wanet_victim_eval_step

    jcfg, cfg = _configs(attack_mode="all2all")
    jbatch, batch = _eval_inputs(49)
    ref, port = _jax_eval("wanet", "grid", jcfg, jbatch, jax.random.key(50), victim=True)
    _assert_metrics(make_wanet_victim_eval_step(cfg, port["C"], port["G"])(batch), ref)


@pytest.mark.parametrize("route", list(ROUTES))
def test_inputaware_victim_eval_step_matches_jax(route):
    from combat_tpu_torch.train.variants import make_inputaware_victim_eval_step

    jcfg, cfg = _route_configs(route)
    jbatch, batch = _eval_inputs(51, pair=True)
    key = jax.random.key(52)
    ref, port = _jax_eval("inputaware", "unet", jcfg, jbatch, key, victim=True)
    got = make_inputaware_victim_eval_step(cfg, port["C"], port["G"])(batch, draws=jax_pair_sigmas(key, cfg, 2))
    _assert_metrics(got, ref)


def test_pair_epoch_follows_two_injected_permutations_with_the_ragged_tail():
    """N = 2*bs + 3 rows: two full batches and a tail of 3; x follows the
    first permutation, x2 the second, each row once in each stream."""
    from combat_tpu_torch.train import train_epoch_alternated_pair

    n = 2 * BS + 3
    x, y = _batch(53, n=24)
    images, labels = nchw(x[:n]), torch.from_numpy(y[:n]).long()
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(4))
    perm2 = torch.randperm(n, generator=torch.Generator().manual_seed(5))
    assert not torch.equal(perm, perm2)
    seen = []

    def step(stateC, stateG, clean_model, netF, batch, generator):
        xb, yb, x2b = batch
        seen.append((xb[:, 0, 0, 0].clone(), yb.clone(), x2b[:, 0, 0, 0].clone()))
        return {"sample": xb.new_tensor(float(xb.shape[0]))}

    m = train_epoch_alternated_pair(step, None, None, None, None, images, labels, torch.Generator().manual_seed(6),
                                    BS, perm=perm, perm2=perm2)
    assert [len(s[0]) for s in seen] == [BS, BS, 3] and float(m["sample"]) == n
    rows, labs, rows2 = (torch.cat(parts) for parts in zip(*seen))
    assert torch.equal(rows, images[perm, 0, 0, 0]) and torch.equal(labs, labels[perm])
    assert torch.equal(rows2, images[perm2, 0, 0, 0])


def test_paired_eval_epoch_pads_and_takes_the_second_stream_from_the_permutation():
    """13 rows at bs 8: two padded batches; the second stream of each row is
    ``images[pair_perm[row]]``, and the padding's validity mask is kept."""
    from combat_tpu_torch.train import eval_epoch

    x, y = _batch(54, n=16)
    images, labels = nchw(x[:13]), torch.from_numpy(y[:13]).long()
    pair_perm = torch.randperm(13, generator=torch.Generator().manual_seed(7))
    seen = []

    def step(batch, generator=None):
        xb, _, x2b, valid = batch
        seen.append((xb[:, 0, 0, 0].clone(), x2b[:, 0, 0, 0].clone(), valid.clone()))
        return {"clean_sample": valid.float().sum()}

    m = eval_epoch(step, (), images, labels, 8, with_pair=True, pair_perm=pair_perm, generator=None)
    assert float(m["clean_sample"]) == 13.0 and len(seen) == 2
    rows, rows2, valid = (torch.cat(parts) for parts in zip(*seen))
    idx = torch.arange(16).clamp(max=12)
    assert torch.equal(rows, images[idx, 0, 0, 0]) and torch.equal(rows2, images[pair_perm[idx], 0, 0, 0])
    assert valid.tolist() == [True] * 13 + [False] * 3
