"""The input-aware and multilabel train steps of the port against the JAX
package's, on every trigger route, from the same converted parameters and
the JAX step's own draws.  Sizes, tolerances and helpers are those of
tests/test_torch_variants.py.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_helpers import jax_alternated_draws, jax_inputaware_draws, nchw
from test_torch_steps import BS, _batch
from test_torch_variants import ROUTES, _rng, _route_configs, _run_train_step


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("COMBAT_PALLAS_INTERPRET", "1")
    torch.set_num_threads(1)


@pytest.mark.parametrize("route", list(ROUTES))
def test_inputaware_step_matches_jax(route):
    """Two G forwards (x and x2) pulled back into one gradient for G; three
    triggers a step (K1 x3, K2 x2 on the fused route)."""
    jcfg, cfg = _route_configs(route)
    x, y = _batch(22)
    x2 = _rng(23).uniform(-1, 1, x.shape).astype(np.float32)
    got = _run_train_step("inputaware", "unet", jcfg, cfg, (x, y, x2),
                          (nchw(x), torch.from_numpy(y).long(), nchw(x2)), jax_inputaware_draws, jax.random.key(24))
    assert 0.0 <= float(got["cross_correct"]) <= BS


@pytest.mark.parametrize("route", list(ROUTES))
def test_multilabel_step_matches_jax(route):
    """The class-conditional G: the C-step triggers rows of any class toward
    their own label; the G-step's targets are the contiguous chunks
    ``min(i // ceil(bs/K), K-1)``."""
    from combat_tpu_torch.train.variants import multilabel_targets

    assert multilabel_targets(8, 10, "cpu").tolist() == list(range(8))
    assert multilabel_targets(25, 10, "cpu").tolist() == [i // 3 for i in range(25)][:25]
    assert multilabel_targets(128, 10, "cpu").tolist() == [min(i // 13, 9) for i in range(128)]
    jcfg, cfg = _route_configs(route)
    x, _ = _batch(27)
    y = _rng(28).integers(0, 10, BS).astype(np.int32)
    _run_train_step("multilabel", "cunet", jcfg, cfg, (x, y), (nchw(x), torch.from_numpy(y).long()),
                    jax_alternated_draws, jax.random.key(29))
