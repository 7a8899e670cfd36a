"""One step of each attack variant in bfloat16 (WaNet, input-aware,
imperceptible, multilabel) against the JAX package's mixed-precision step,
from the same converted parameters, inputs and draws, on the K1/K2 route.

Sizes are those of tests/test_torch_variants.py; the criterion (``combat_tpu_torch/utils/gap.py``)
and the check of the kernels' inputs are those of
tests/test_torch_bf16_steps.py.  WaNet's flow stays bfloat16 through the
bicubic upsample and its L2 term (as in the JAX package), and its grid is
float32 (``attack/triggers.py::warp_grid``); it runs no trigger kernel.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from _torch_helpers import jax_alternated_draws, jax_inputaware_draws, jax_wanet_draws, nchw
from test_torch_bf16_models import one_torch_thread, release_memory
from test_torch_bf16_steps import PlainInputs, assert_step_gap, converted, low_precision, run_jax_both
from test_torch_steps import BS, _batch
from test_torch_variants import _configs, _port_states, _rng, _variant_models


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
def variant_models():
    """``get(kind)``: the JAX states and a copy of the port's models of
    tests/test_torch_variants.py, each kind built once for this file."""
    built = {}

    def get(kind):
        if kind not in built:
            built[kind] = _variant_models(kind)
        j, port = built[kind]
        return j, copy.deepcopy(port)

    return get


def _batches(variant):
    x, y = _batch({"wanet": 20, "inputaware": 22, "imperceptible": 25, "multilabel": 27}[variant])
    if variant == "multilabel":
        y = _rng(28).integers(0, 10, BS).astype(np.int32)
    if variant == "inputaware":
        x2 = _rng(23).uniform(-1, 1, x.shape).astype(np.float32)
        return (x, y, x2), (nchw(x), torch.from_numpy(y).long(), nchw(x2))
    return (x, y), (nchw(x), torch.from_numpy(y).long())


# variant: (generator kind, the JAX step's draws, K1 / K2 plain-version calls a step)
VARIANTS = {
    "wanet": ("grid", jax_wanet_draws, (0, 0)),
    "inputaware": ("unet", jax_inputaware_draws, (3, 2)),
    "imperceptible": ("unet", jax_alternated_draws, (2, 1)),
    "multilabel": ("cunet", jax_alternated_draws, (2, 1)),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_variant_step_matches_the_jax_recipe(variant, variant_models, monkeypatch):
    import combat_tpu.train.variants as jv

    import combat_tpu_torch.train.variants as pv

    kind, draws_fn, (k1, k2) = VARIANTS[variant]
    mode = "all2all" if variant == "wanet" else "all2one"  # as tests/test_torch_variants.py runs WaNet
    jcfg, cfg = _configs(pallas_trigger=True, pallas_lowfreq=False, attack_mode=mode)
    j, port = variant_models(kind)
    jbatch, pbatch = _batches(variant)
    key = jax.random.key(21)
    make = f"make_{variant}_train_step"
    (sC, sG, ref), (sC_lo, sG_lo, ref_lo) = run_jax_both(
        lambda: getattr(jv, make)(jcfg, j["C"], j["G"]), j["sC"], j["sG"], j["cm"], j["nf"], jbatch, key)

    results = {}
    for name, models in (("f32", port), ("lo", low_precision(port))):
        plain = PlainInputs(monkeypatch) if name == "lo" else None
        stateC, stateG, cm, nf = _port_states(models)
        m = getattr(pv, make)(cfg, models["C"], models["G"])(stateC, stateG, cm, nf, pbatch,
                                                            draws=draws_fn(key, cfg, BS))
        results[name] = (m, models["C"].state_dict(), models["G"].state_dict())
    (m32, c32, g32), (m_lo, c_lo, g_lo) = results["f32"], results["lo"]

    assert_step_gap(m_lo, ref_lo, ref, [("C", c_lo, c32, converted(sC_lo, "preactresnet18"),
                                         converted(sC, "preactresnet18")),
                                        ("G", g_lo, g32, converted(sG_lo, kind), converted(sG, kind))])
    assert plain.all_float32(), plain.dtypes
    assert plain.n == {"fused_trigger_fwd_plain": k1, "fused_trigger_bwd_plain": k2, "low_freq_plain": 0}
