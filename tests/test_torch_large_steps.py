"""The slice as a whole above 64 px: one alternated step and one victim step
of the port against the JAX package's at 80 px, with the celeba classifier
(ResNet18, 8 classes) and the UNet as G, from the same converted weights
and the same random draws (recreated from the JAX step key).

80 px is the smallest size above 64 that the UNet takes (its four
poolings need H divisible by 16; at 72 its 9 px map pools to 4 and comes
back as 8).  ResNet18's pooled map is 2x2 there, so the head's permutation
is in the step.  bs 2 and UNet nf 8 keep it cheap on the CPU.  On the
CPU the trigger runs its kernels' plain versions (the card runs the tiled
kernels there); the JAX side runs its Pallas kernels in interpret mode.

Tolerances: losses 2e-4 absolute plus 2e-4 relative and counts exactly, as
tests/test_torch_steps.py; G's updated parameters 5e-5.  C's updated
parameters are held to the JAX step's own conditioning, which each test
measures: full-width ResNet18 at 80 px has ~10^6 ReLU units after
BatchNorm, so a float32 difference flips a few that sit near 0 and moves
the weight gradients they feed by a finite amount.  The JAX step is run
again on its input plus Gaussian noise of 1e-5, the size of the port's
difference from it in the augmentation's resample (tests/test_torch_ops.py);
the port's C may differ from the JAX step's by no more than twice the
rerun's largest difference (and 5e-4 in any case), with no more of its
11.2 M numbers beyond 5e-5 than the rerun has.  (Measured here: the port
1.8e-4 and 2.1e-4 at most, 1,345 and 421 numbers beyond 5e-5, in the
alternated and the victim step; the reruns 2.9e-4 and 2.2e-4, 36,235 and
10,848.)  One step at lr 0.01 moves C's
parameters by up to ~1e-2, so a fault of the port shows far above that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (
    assert_state_close,
    jax_alternated_draws,
    jax_aug_draws,
    jax_sigma,
    nchw,
    to_numpy_tree,
)
from combat_tpu_torch.checkpoint import from_jax_params
from test_torch_steps import PARAM_TOL, _assert_metrics

BS, SIZE, NF = 2, 80, 8


def _far(sd_a, sd_b):
    """(largest difference, count of numbers differing by more than 5e-5)
    between two classifier state_dicts."""
    worst = far = 0
    for k, v in sd_b.items():
        if not k.endswith("num_batches_tracked"):
            d = (sd_a[k] - v).abs()
            worst, far = max(worst, float(d.max())), far + int((d > 5e-5).sum())
    return worst, far


def _assert_classifier_close(port_sd, jax_sd, jax_noisy_sd):
    """C's parameters against the JAX step's, bounded by the JAX step's own
    rerun on an input with noise of 1e-5 (see the module docstring)."""
    worst, far = _far(port_sd, jax_sd)
    self_worst, self_far = _far(jax_noisy_sd, jax_sd)
    print(f"C vs JAX: max {worst:.3e}, {far} beyond 5e-5; JAX vs its noisy rerun: max {self_worst:.3e}, "
          f"{self_far} beyond 5e-5")
    assert worst <= min(5e-4, 2 * self_worst), (worst, self_worst)
    assert far <= self_far, (far, self_far)


def _noisy(x):
    return x + np.random.default_rng(99).standard_normal(x.shape).astype(np.float32) * 1e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("COMBAT_PALLAS_INTERPRET", "1")
    torch.set_num_threads(1)


def _configs(**kw):
    from combat_tpu.config import Config as JaxConfig
    from combat_tpu.config import apply_dataset_preset as jax_preset

    from combat_tpu_torch.config import Config, apply_dataset_preset

    size = dict(input_height=SIZE, input_width=SIZE, bs=BS, **kw)
    jcfg = jax_preset(JaxConfig(dataset="celeba", synthetic_data=True)).replace(**size)
    cfg = apply_dataset_preset(Config(dataset="celeba", device="cpu", synthetic_data=True)).replace(**size)
    return jcfg, cfg


def _models(num_classes=8):
    """JAX states (ResNet18 C and clean model, UNet G, the detector) and
    the port's models loaded from the same weights."""
    from combat_tpu.models.frequency import FrequencyModel as JaxFrequency
    from combat_tpu.models.generators import UnetGenerator as JaxUnet
    from combat_tpu.models.resnet import resnet18 as jax_resnet18
    from combat_tpu.train import init_frozen, init_train_state, multistep_lr, sgd_torch

    from combat_tpu_torch.models import FrequencyModel, UnetGenerator, resnet18

    tx = sgd_torch(multistep_lr(0.01, (100,), 0.1, 10))
    sample = jnp.zeros((1, SIZE, SIZE, 3))
    C, G, F = jax_resnet18(num_classes), JaxUnet(nf=NF), JaxFrequency(num_classes=2)
    j = dict(
        C=C, G=G,
        sC=init_train_state(C, jax.random.key(0), sample, tx),
        sG=init_train_state(G, jax.random.key(1), sample, tx),
        cm=init_frozen(C, jax.random.key(2), sample),
        nf=init_frozen(F, jax.random.key(3), sample),
    )

    def load(module, variables, kind):
        module.load_state_dict(from_jax_params(to_numpy_tree(variables), kind))
        return module

    port = dict(
        C=load(resnet18(num_classes, SIZE), j["sC"].variables, "resnet"),
        G=load(UnetGenerator(nf=NF), j["sG"].variables, "unet"),
        cm=load(resnet18(num_classes, SIZE), j["cm"].variables, "resnet"),
        nf=load(FrequencyModel(num_classes=2, input_size=SIZE), j["nf"].variables, "frequency"),
    )
    return j, port


def _batch(seed=0):
    x = np.random.default_rng(seed).uniform(-1, 1, (BS, SIZE, SIZE, 3)).astype(np.float32)
    return x, np.array([0, 3], np.int32)  # a target-class row, so the poison draw can pick it


def test_alternated_step_at_80px_matches_jax():
    from combat_tpu.train import make_alternated_train_step as jax_make

    from combat_tpu_torch.train import TrainState, freeze, make_alternated_train_step, multistep_lr

    jcfg, cfg = _configs(pc=1.0)  # the target-class row is poisoned
    j, port = _models()
    x, y = _batch()
    key = jax.random.key(21)
    jstep = jax.jit(jax_make(jcfg, j["C"], j["G"]))
    sC, sG, ref = jstep(j["sC"], j["sG"], j["cm"], j["nf"], (x, y), key)
    sC_noisy = jstep(j["sC"], j["sG"], j["cm"], j["nf"], (_noisy(x), y), key)[0]

    sched = multistep_lr(0.01, (100,), 0.1, 10)
    stateC, stateG = TrainState(port["C"], sched), TrainState(port["G"], sched)
    step = make_alternated_train_step(cfg, port["C"], port["G"])
    draws = jax_alternated_draws(key, cfg, BS)
    assert bool(draws.poison[0])
    got = step(stateC, stateG, freeze(port["cm"]), freeze(port["nf"]), (nchw(x), torch.from_numpy(y).long()),
               draws=draws)

    _assert_metrics(got, ref)
    assert (stateC.step, stateG.step) == (int(sC.step), int(sG.step)) == (1, 1)
    _assert_classifier_close(port["C"].state_dict(), from_jax_params(to_numpy_tree(sC.variables), "resnet"),
                             from_jax_params(to_numpy_tree(sC_noisy.variables), "resnet"))
    assert_state_close(port["G"].state_dict(), from_jax_params(to_numpy_tree(sG.variables), "unet"), **PARAM_TOL)


def test_victim_step_at_80px_matches_jax():
    from combat_tpu.train import make_victim_train_step as jax_make

    from combat_tpu_torch.train import TrainState, VictimDraws, make_victim_train_step, multistep_lr

    jcfg, cfg = _configs()
    j, port = _models()
    x, y = _batch(1)
    poisoned = np.array([False, True])
    key = jax.random.key(22)
    jstep = jax.jit(jax_make(jcfg, j["C"], j["G"]))
    sC, ref = jstep(j["sC"], j["sG"].params, (x, y, poisoned), key)
    sC_noisy = jstep(j["sC"], j["sG"].params, (_noisy(x), y, poisoned), key)[0]

    k = jax.random.split(key, 3)
    draws = VictimDraws(sigma=jax_sigma(k[0], cfg.sigma), aug=jax_aug_draws(k[1], BS))
    stateC = TrainState(port["C"], multistep_lr(0.01, (100,), 0.1, 10))
    step = make_victim_train_step(cfg, port["C"], port["G"])
    got = step(stateC, (nchw(x), torch.from_numpy(y).long(), torch.from_numpy(poisoned)), draws=draws)

    _assert_metrics(got, ref)
    assert stateC.step == int(sC.step) == 1
    _assert_classifier_close(port["C"].state_dict(), from_jax_params(to_numpy_tree(sC.variables), "resnet"),
                             from_jax_params(to_numpy_tree(sC_noisy.variables), "resnet"))
