"""The alternated and victim steps in bfloat16: the port against the JAX
package's mixed-precision step, from the same converted parameters, inputs
and draws, by the gap criterion of ``combat_tpu_torch/utils/gap.py``.

Sizes are those of tests/test_torch_steps.py (PreActResNet with one block
per stage, UNet nf=8, bs 8, full metrics); the JAX side runs its Pallas
trigger kernels in interpret mode, the port its kernels' plain versions.
Each step runs four times: JAX and the port, each in float32 and in
bfloat16.  Every parameter, every BatchNorm statistic and every loss after
the step is held by the criterion, and counts of correct predictions
within ``gap.COUNT_ALLOWANCE`` rows of the JAX package's bfloat16 step: a
near-tie of two bfloat16 logits can land on either side under two
roundings (measured here: no count differed, in any of the eight steps).  The trigger math stays float32 (the JAX
package's ``noise.astype(x.dtype)``), so every tensor that reaches the
plain versions of K1, K2 and K3 is float32; wrapped plain versions check it.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from _torch_helpers import jax_alternated_draws, jax_aug_draws, jax_sigma, nchw, to_numpy_tree
from combat_tpu_torch.checkpoint import from_jax_params
from combat_tpu_torch.utils import gap
from test_torch_bf16_models import jax_compute_dtype, one_torch_thread, release_memory
from test_torch_steps import BS, _batch, _configs, _models

COUNT_KEYS = ("correct", "sample", "bd_ba", "bd_asr")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("COMBAT_PALLAS_INTERPRET", "1")


@pytest.fixture(autouse=True)
def _float32_after():
    from combat_tpu.models.layers import compute_dtype

    with one_torch_thread():
        release_memory()
        yield
        release_memory()
    assert compute_dtype() is None


@pytest.fixture(scope="module")
def models():
    """The JAX states and the port's models of tests/test_torch_steps.py,
    built once for this file (a test steps copies of the port's)."""
    return _models()


def low_precision(port: dict) -> dict:
    """Copies of the port's models that compute in bfloat16."""
    from combat_tpu_torch.models import set_compute_dtype

    return {k: set_compute_dtype(copy.deepcopy(m), torch.bfloat16) for k, m in port.items()}


def run_jax_both(make, *args):
    """The jitted JAX step, traced once in float32 and once in bfloat16."""
    f32 = jax.jit(make())(*args)
    with jax_compute_dtype("bfloat16"):
        lo = jax.jit(make())(*args)
    return f32, lo


def assert_step_gap(port_lo: dict, jax_lo: dict, jax_f32: dict, pairs) -> None:
    """The step's losses, counts, parameters and statistics by the gap
    criterion (``gap.step_failures``).  ``pairs``: (name, port low, port
    f32, JAX low, JAX f32) state dicts, the JAX ones converted; the port's
    low-precision model keeps float32 parameters and statistics."""
    assert set(port_lo) == set(jax_lo)
    losses = [k for k in sorted(jax_lo) if not k.endswith(COUNT_KEYS)]
    failures = gap.step_failures("step", port_lo, jax_lo, jax_f32, losses, pairs)
    assert not failures, "\n".join(failures)


def converted(state, kind: str) -> dict:
    """A JAX train state as the port's ``state_dict``."""
    return from_jax_params(to_numpy_tree(state.variables), kind)


class PlainInputs:
    """Records the dtypes of the tensors that reach the kernels' plain
    versions (the CPU path of K1, K2 and K3)."""

    NAMES = ("fused_trigger_fwd_plain", "fused_trigger_bwd_plain", "low_freq_plain")

    def __init__(self, monkeypatch):
        from combat_tpu_torch.ops import trigger_kernels as tk

        self.dtypes = {n: [] for n in self.NAMES}
        self.n = dict.fromkeys(self.NAMES, 0)
        for n in self.NAMES:
            monkeypatch.setattr(tk, n, self._wrap(n, getattr(tk, n)))

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            self.dtypes[name].extend(a.dtype for a in args if isinstance(a, torch.Tensor))
            self.n[name] += 1
            return fn(*args, **kw)

        return wrapped

    def all_float32(self) -> bool:
        return all(d == torch.float32 for ds in self.dtypes.values() for d in ds)


ROUTES = {"pallas_trigger": (True, False), "lowfreq_kernel": (False, True)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_bf16_alternated_step_matches_the_jax_recipe(route, models, monkeypatch):
    """The alternated step on the K1/K2 route and on K3's, each against the
    JAX package's step on the same route (the routes differ by float32
    rounding, ~1e-6, more than bfloat16 moves the UNet's output conv); the
    kernels' plain versions see float32 only."""
    from combat_tpu.train import make_alternated_train_step as jax_make

    from combat_tpu_torch.train import make_alternated_train_step
    from test_torch_steps import _port_states

    fused, lowfreq = ROUTES[route]
    jcfg, cfg = _configs(pallas_trigger=fused, pallas_lowfreq=lowfreq)
    j, port = models[0], copy.deepcopy(models[1])
    x, y = _batch()
    key = jax.random.key(11)
    (sC, sG, ref), (sC_lo, sG_lo, ref_lo) = run_jax_both(
        lambda: jax_make(jcfg, j["C"], j["G"]), j["sC"], j["sG"], j["cm"], j["nf"], (x, y), key)

    results = {}
    for name, nets in (("f32", port), ("lo", low_precision(port))):
        plain = PlainInputs(monkeypatch) if name == "lo" else None
        stateC, stateG, cm, nf = _port_states(nets)
        step = make_alternated_train_step(cfg, nets["C"], nets["G"])
        m = step(stateC, stateG, cm, nf, (nchw(x), torch.from_numpy(y).long()),
                 draws=jax_alternated_draws(key, cfg, BS))
        results[name] = (m, nets["C"].state_dict(), nets["G"].state_dict())
    (m32, c32, g32), (m_lo, c_lo, g_lo) = results["f32"], results["lo"]

    assert_step_gap(m_lo, ref_lo, ref, [(what, p_lo, p32, converted(j_lo, kind), converted(j32, kind))
                                        for what, kind, p_lo, p32, j_lo, j32 in (
                                            ("C", "preactresnet18", c_lo, c32, sC_lo, sC),
                                            ("G", "unet", g_lo, g32, sG_lo, sG))])
    assert plain.all_float32(), plain.dtypes
    # K1 twice (the C-step's and the G-step's trigger), K2 once; or K3 three
    # times (two forwards, one backward)
    expected = {"fused_trigger_fwd_plain": 2, "fused_trigger_bwd_plain": 1, "low_freq_plain": 0} if fused else {
        "fused_trigger_fwd_plain": 0, "fused_trigger_bwd_plain": 0, "low_freq_plain": 3}
    assert plain.n == expected, plain.n


def test_bf16_victim_step_matches_the_jax_recipe(models, monkeypatch):
    """The victim step on the K1 route (G frozen, in bfloat16): C's
    parameters and statistics, the loss and the count; K1's plain version
    sees float32 only."""
    from combat_tpu.train import make_victim_train_step as jax_make

    from combat_tpu_torch.train import TrainState, VictimDraws, make_victim_train_step, multistep_lr
    from test_torch_victim import POISONED

    jcfg, cfg = _configs(pallas_trigger=True, pallas_lowfreq=False)
    j, port = models[0], copy.deepcopy(models[1])
    x, y = _batch(8)
    key = jax.random.key(12)
    (sC, ref), (sC_lo, ref_lo) = run_jax_both(lambda: jax_make(jcfg, j["C"], j["G"]), j["sC"], j["sG"].params,
                                              (x, y, POISONED), key)
    k = jax.random.split(key, 3)
    draws = VictimDraws(sigma=jax_sigma(k[0], cfg.sigma), aug=jax_aug_draws(k[1], BS))
    results = {}
    for name, nets in (("f32", port), ("lo", low_precision(port))):
        plain = PlainInputs(monkeypatch) if name == "lo" else None
        stateC = TrainState(nets["C"], multistep_lr(0.01, (100,), 0.1, 10))
        step = make_victim_train_step(cfg, nets["C"], nets["G"])
        m = step(stateC, (nchw(x), torch.from_numpy(y).long(), torch.from_numpy(POISONED)), draws=draws)
        results[name] = (m, nets["C"].state_dict())
    (m32, c32), (m_lo, c_lo) = results["f32"], results["lo"]
    assert_step_gap(m_lo, ref_lo, ref, [("C", c_lo, c32, converted(sC_lo, "preactresnet18"),
                                         converted(sC, "preactresnet18"))])
    assert plain.all_float32(), plain.dtypes
    assert plain.n == {"fused_trigger_fwd_plain": 1, "fused_trigger_bwd_plain": 0, "low_freq_plain": 0}
