"""The attack variants' ops, generators and train steps: the port against
the JAX package, from the same converted parameters, inputs made with numpy
from a seed, and the JAX step's own random draws.

Ops and generators are held to 1e-5 absolute.  Steps use the sizes and
tolerances of tests/test_torch_steps.py (PreActResNet with one block per
stage, UNet / CUnet / Grid nf=8, bs 8; losses 2e-4 absolute plus 2e-4
relative, updated parameters 5e-5 absolute, counts exactly), on every
trigger route of the three additive variants: ``pallas_trigger`` (K1/K2),
``lowfreq_kernel`` (K3, then clamp and blur) and ``aten`` (no kernel).  The
JAX side runs its Pallas kernels in interpret mode.  The input-aware and
multilabel train steps are in tests/test_torch_variant_steps.py, the eval
and victim steps and the pair epoch in tests/test_torch_variant_evals.py,
the CLIs in tests/test_torch_variant_cli.py (each file a few JAX compiles,
so that no one file sets the pace of a parallel run).

``grid_sample``'s gradient in the grid: torch's backward is floor-based,
the JAX hat form ``relu(1 - |f - k|)`` has a balanced subgradient where a
sample sits exactly on a pixel centre.  At generic positions they agree to
1e-5; a clamped grid puts samples on the border pixels, where only the
grid gradient differs (and the clamp zeroes it in the warp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (
    assert_state_close,
    jax_alternated_draws,
    jax_wanet_draws,
    nchw,
    nhwc,
    to_numpy_tree,
)
from combat_tpu_torch.checkpoint import from_jax_params
from test_torch_steps import BS, PARAM_TOL, _assert_metrics, _batch, _configs

OP_TOL = dict(atol=1e-5, rtol=0.0)
ROUTES = {"pallas_trigger": (True, False), "lowfreq_kernel": (False, True), "aten": (False, False)}
GENERATOR_KINDS = ("unet_bk", "grid", "mixed", "cunet", "fixed")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("COMBAT_PALLAS_INTERPRET", "1")
    torch.set_num_threads(1)


def _rng(seed):
    return np.random.default_rng(seed)


# --------------------------------------------------------------------------
# ops/image.py and attack/triggers.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n_in,n_out,method,align",
    [(2, 32, "bicubic", True), (4, 32, "bicubic", True), (8, 16, "bilinear", False), (16, 8, "bilinear", True),
     (5, 7, "nearest", False)],
)
def test_resize2d_matches_jax(n_in, n_out, method, align):
    from combat_tpu.ops.image import resize2d as jax_resize

    from combat_tpu_torch.ops.image import resize2d

    x = _rng(0).uniform(-1, 1, (3, n_in, n_in, 2)).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(x), (n_out, n_out), method=method, align_corners=align))
    got = nhwc(resize2d(nchw(x), (n_out, n_out), method=method, align_corners=align))
    np.testing.assert_allclose(got, ref, **OP_TOL)


def test_upsample2x_bilinear_and_total_variation_match_jax():
    from combat_tpu.ops.image import total_variation as jax_tv
    from combat_tpu.ops.image import upsample2x_bilinear as jax_up

    from combat_tpu_torch.ops.image import total_variation, upsample2x_bilinear

    x = _rng(1).uniform(-1, 1, (4, 8, 8, 5)).astype(np.float32)
    np.testing.assert_allclose(nhwc(upsample2x_bilinear(nchw(x))), np.asarray(jax_up(jnp.asarray(x))), **OP_TOL)
    ref = np.asarray(jax_tv(jnp.asarray(x)))
    got = total_variation(nchw(x)).numpy()
    assert got.shape == ref.shape == (4,)
    _assert_close_to_scale(got, ref)  # sums of ~600 terms of O(1)


def _assert_close_to_scale(got, ref):
    """1e-5 of the largest magnitude: for sums of many O(1) terms, whose
    float32 rounding grows with the sum."""
    np.testing.assert_allclose(got, ref, atol=1e-5 * float(np.abs(ref).max()), rtol=0.0)


def _tanh_grid(seed, n=2, h=16, scale=1.0):
    """A grid of random positions in (-1, 1): tanh of a Gaussian field."""
    return np.tanh(_rng(seed).normal(0, scale, (n, h, h, 2))).astype(np.float32)


def _grid_sample_pair(x, grid, g):
    """Forward and VJP (in x and grid) of both implementations."""
    from combat_tpu.ops.image import grid_sample as jax_gs

    from combat_tpu_torch.ops.image import grid_sample

    out, vjp = jax.vjp(lambda a, b: jax_gs(a, b, align_corners=True), jnp.asarray(x), jnp.asarray(grid))
    ref_gx, ref_gg = vjp(jnp.asarray(g))
    xt, gt = nchw(x).requires_grad_(), torch.from_numpy(grid).requires_grad_()
    got = grid_sample(xt, gt)
    got_gx, got_gg = torch.autograd.grad(got, (xt, gt), grad_outputs=nchw(g))
    return (np.asarray(out), np.asarray(ref_gx), np.asarray(ref_gg)), (nhwc(got), nhwc(got_gx), got_gg.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_grid_sample_forward_and_vjp_match_jax_at_tanh_positions(seed):
    x = _rng(seed + 10).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    grid = _tanh_grid(seed, scale=1.5)  # some samples near the border: partial zero-padding taps
    g = _rng(seed + 20).normal(size=(2, 16, 16, 3)).astype(np.float32)
    ref, got = _grid_sample_pair(x, grid, g)
    for name, a, b in zip(("out", "d/dx", "d/dgrid"), got, ref):
        np.testing.assert_allclose(a, b, err_msg=name, **OP_TOL)


def test_grid_sample_with_a_clamped_grid_differs_from_jax_only_at_exact_pixel_centres():
    """Clamping to [-1, 1] puts samples exactly on the border pixels' centres.
    The values and the gradient in x agree there; the gradient in the grid
    agrees wherever the sample is off a pixel centre, and is what differs
    at the clamped samples."""
    x = _rng(3).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    grid = np.clip(_tanh_grid(4, scale=1.0) * 1.3, -1.0, 1.0)
    g = _rng(5).normal(size=(2, 16, 16, 3)).astype(np.float32)
    (out, ref_gx, ref_gg), (got, got_gx, got_gg) = _grid_sample_pair(x, grid, g)
    np.testing.assert_allclose(got, out, **OP_TOL)
    np.testing.assert_allclose(got_gx, ref_gx, **OP_TOL)
    on_centre = np.abs(grid) == 1.0  # f = 0 or W-1 exactly
    assert on_centre.any() and not on_centre.all()
    np.testing.assert_allclose(got_gg[~on_centre], ref_gg[~on_centre], **OP_TOL)
    assert not np.allclose(got_gg[on_centre], ref_gg[on_centre], atol=1e-5)


@pytest.mark.parametrize("clamp", [True, False])
def test_warp_trigger_and_its_flow_gradient_match_jax(clamp):
    """The whole warp from an NCHW (B, 2, s, s) flow: the bicubic upsample,
    the permute to the (B, H, W, 2) grid, the blend and the clamp.  With the
    clamp, its zero gradient hides the samples it moved to a pixel centre."""
    from combat_tpu.attack.triggers import identity_grid as jax_identity
    from combat_tpu.attack.triggers import warp_trigger as jax_warp

    from combat_tpu_torch.attack.triggers import identity_grid, warp_trigger

    np.testing.assert_allclose(identity_grid(16, 12).numpy(), np.asarray(jax_identity(16, 12)), **OP_TOL)
    x = _rng(6).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    flow = np.tanh(_rng(7).normal(0, 2, (2, 2, 2, 2))).astype(np.float32)  # NHWC (B, s, s, 2)
    g = _rng(8).normal(size=(2, 16, 16, 3)).astype(np.float32)
    rescale = 1.5  # large enough that the clamp binds: ~10% of the samples

    def jax_fn(fl):
        return jax_warp(jnp.asarray(x), fl, grid_rescale=rescale, clamp_grid=clamp)

    ref, vjp = jax.vjp(jax_fn, jnp.asarray(flow))
    (ref_gf,) = vjp(jnp.asarray(g))
    ft = nchw(flow).requires_grad_()
    got = warp_trigger(nchw(x), ft, grid_rescale=rescale, clamp_grid=clamp)
    (got_gf,) = torch.autograd.grad(got, ft, grad_outputs=nchw(g))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **OP_TOL)
    _assert_close_to_scale(nhwc(got_gf), np.asarray(ref_gf))  # sums over 16x16 samples


# --------------------------------------------------------------------------
# models/generators.py and checkpoint/convert.py
# --------------------------------------------------------------------------


def _generator_pair(kind, nf=8):
    from combat_tpu.models import generators as J

    from combat_tpu_torch.models import generators as P

    return {
        "unet_bk": (J.UnetGeneratorBK(nf=nf), P.UnetGeneratorBK(nf=nf)),
        "grid": (J.GridGenerator(nf=nf), P.GridGenerator(nf=nf)),
        "mixed": (J.MixedGenerator(nf=nf), P.MixedGenerator(nf=nf)),
        "cunet": (J.CUnetGenerator(nf=nf), P.CUnetGenerator(nf=nf)),
        "fixed": (J.FixedTriggerGenerator(), P.FixedTriggerGenerator()),
    }[kind]


def _gen_args(kind, y):
    return (y,) if kind == "cunet" else ()


def _as_nchw(a):
    a = np.asarray(a)
    return a.transpose(0, 3, 1, 2)


@pytest.mark.parametrize("kind", GENERATOR_KINDS)
def test_generator_matches_jax_with_converted_weights(kind):
    jm, port = _generator_pair(kind)
    x = _rng(9).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    y = np.array([0, 4, 9], np.int32)
    variables = to_numpy_tree(jm.init(jax.random.key(0), jnp.asarray(x), *_gen_args(kind, jnp.asarray(y))))
    port.load_state_dict(from_jax_params(variables, kind))
    ref = jm.apply(variables, jnp.asarray(x), *_gen_args(kind, jnp.asarray(y)))
    got = port(nchw(x), *_gen_args(kind, torch.from_numpy(y).long()))
    refs, gots = (ref, got) if kind == "mixed" else ((ref,), (got,))
    for r, g in zip(refs, gots):
        assert g.shape == _as_nchw(r).shape
        np.testing.assert_allclose(g.detach().numpy(), _as_nchw(r), **OP_TOL)


@pytest.mark.parametrize("kind", GENERATOR_KINDS)
def test_generator_parameter_counts_at_full_width(kind):
    """nf=64 (s=2, 10 classes, 32x32x3), as ``get_generator`` builds them."""
    from combat_tpu.config import Config as JaxConfig
    from combat_tpu.config import apply_dataset_preset as jax_preset
    from combat_tpu.models.registry import get_generator as jax_generator

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_generator

    jcfg = jax_preset(JaxConfig())
    jm = jax_generator(jcfg, kind)
    x = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), x, *_gen_args(kind, jnp.zeros((1,), jnp.int32))))
    ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    port = get_generator(apply_dataset_preset(Config()), kind)
    assert sum(p.numel() for p in port.parameters()) == ref


# --------------------------------------------------------------------------
# train/variants.py: the four train steps
# --------------------------------------------------------------------------


def _variant_models(kind):
    """JAX states and the port's models from the same weights: C and the
    clean model PreActResNet (1 block per stage), netF the frequency
    detector, G of ``kind`` at nf=8."""
    from combat_tpu.models import generators as J
    from combat_tpu.models.frequency import FrequencyModel as JaxFrequency
    from combat_tpu.models.preact_resnet import PreActResNet as JaxPreAct
    from combat_tpu.train import init_frozen, init_train_state, multistep_lr, sgd_torch

    from combat_tpu_torch.models import FrequencyModel, PreActResNet
    from combat_tpu_torch.models import generators as P

    tx = sgd_torch(multistep_lr(0.01, (100,), 0.1, 10))
    sample = jnp.zeros((1, 32, 32, 3))
    C, F = JaxPreAct([1, 1, 1, 1], 10), JaxFrequency(num_classes=2)
    jG, pG = {"unet": (J.UnetGenerator(nf=8), P.UnetGenerator(nf=8))}.get(kind) or _generator_pair(kind)
    extra = (jnp.zeros((1,), jnp.int32),) if kind == "cunet" else ()
    j = dict(
        C=C, G=jG,
        sC=init_train_state(C, jax.random.key(0), sample, tx),
        sG=init_train_state(jG, jax.random.key(1), sample, tx, extra_args=extra),
        cm=init_frozen(C, jax.random.key(2), sample),
        nf=init_frozen(F, jax.random.key(3), sample),
    )

    def load(module, variables, k):
        module.load_state_dict(from_jax_params(to_numpy_tree(variables), k))
        return module

    port = dict(
        C=load(PreActResNet((1, 1, 1, 1), 10), j["sC"].variables, "preactresnet18"),
        G=load(pG, j["sG"].variables, kind),
        cm=load(PreActResNet((1, 1, 1, 1), 10), j["cm"].variables, "preactresnet18"),
        nf=load(FrequencyModel(num_classes=2), j["nf"].variables, "frequency"),
    )
    return j, port


def _port_states(port):
    from combat_tpu_torch.train import TrainState, freeze, multistep_lr

    sched = multistep_lr(0.01, (100,), 0.1, 10)
    return TrainState(port["C"], sched), TrainState(port["G"], sched), freeze(port["cm"]), freeze(port["nf"])


def _run_train_step(variant, kind, jcfg, cfg, batch, port_batch, draws_fn, key):
    """One step of the JAX variant and of the port's from the same weights
    and draws; C and G after the step, held to each other."""
    import combat_tpu.train.variants as jv

    import combat_tpu_torch.train.variants as pv

    j, port = _variant_models(kind)
    make = f"make_{variant}_train_step"
    sC, sG, ref = jax.jit(getattr(jv, make)(jcfg, j["C"], j["G"]))(j["sC"], j["sG"], j["cm"], j["nf"], batch, key)
    stateC, stateG, cm, nf = _port_states(port)
    got = getattr(pv, make)(cfg, port["C"], port["G"])(stateC, stateG, cm, nf, port_batch, draws=draws_fn(key, cfg, BS))
    _assert_metrics(got, ref)
    assert (stateC.step, stateG.step) == (int(sC.step), int(sG.step)) == (1, 1)
    assert_state_close(port["C"].state_dict(), from_jax_params(to_numpy_tree(sC.variables), "preactresnet18"),
                       **PARAM_TOL)
    assert_state_close(port["G"].state_dict(), from_jax_params(to_numpy_tree(sG.variables), kind), **PARAM_TOL)
    return got


def _route_configs(route, **kw):
    fused, lowfreq = ROUTES[route]
    return _configs(pallas_trigger=fused, pallas_lowfreq=lowfreq, **kw)


@pytest.mark.parametrize("mode", ["all2all"])
def test_wanet_step_matches_jax(mode):
    """The warp step runs no trigger kernel, so it has one route; its
    ``loss_grad_l2`` pads the (B, H, W, 2) flow as the reference does."""
    jcfg, cfg = _configs(attack_mode=mode)
    x, y = _batch(20)
    got = _run_train_step("wanet", "grid", jcfg, cfg, (x, y), (nchw(x), torch.from_numpy(y).long()),
                          jax_wanet_draws, jax.random.key(21))
    assert float(got["loss_grad_l2"]) > 0.0


@pytest.mark.parametrize("route", list(ROUTES))
def test_imperceptible_step_matches_jax(route):
    """The total-variation term backpropagates through the trigger (K2 on the
    fused route, K3's VJP on the low-pass route)."""
    jcfg, cfg = _route_configs(route)
    x, y = _batch(25)
    got = _run_train_step("imperceptible", "unet", jcfg, cfg, (x, y), (nchw(x), torch.from_numpy(y).long()),
                          jax_alternated_draws, jax.random.key(26))
    assert float(got["loss_tv"]) > 0.0


def test_variant_steps_loss_only_mode_is_trajectory_identical():
    """As for the base step: the metric-only forwards feed no gradient and
    every draw is made in both modes, so ``loss_only`` leaves bit-identical
    parameters and zero metric-only counts (input-aware, the widest step)."""
    from combat_tpu_torch.train.variants import make_inputaware_train_step

    x, y = _batch(30)
    x2 = _rng(31).uniform(-1, 1, x.shape).astype(np.float32)
    batch = (nchw(x), torch.from_numpy(y).long(), nchw(x2))
    out = {}
    for mode in ("full", "loss_only"):
        _, cfg = _configs(train_metrics=mode)
        _, port = _variant_models("unet")
        stateC, stateG, cm, nf = _port_states(port)
        step = make_inputaware_train_step(cfg, port["C"], port["G"])
        m = step(stateC, stateG, cm, nf, batch, torch.Generator().manual_seed(7))
        out[mode] = (m, port["C"].state_dict(), port["G"].state_dict())
    (m_full, c_full, g_full), (m_lo, c_lo, g_lo) = out["full"], out["loss_only"]
    for a, b in ((c_full, c_lo), (g_full, g_lo)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for k in ("loss_ce", "loss_cross", "loss_l2", "clean_model_loss", "bd_correct", "cross_correct"):
        assert torch.equal(m_full[k], m_lo[k]), k
    assert all(float(m_lo[k]) == 0.0 for k in ("clean_correct", "F_correct", "clean_model_correct"))
