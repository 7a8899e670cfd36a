"""The attack variants above 64 px: the port against the JAX package at 80
px with the celeba preset's 8 classes, and the generators and the warp at
celeba's 64 px and imagenet10's 224 px.

80 px is the smallest size above 64 that the UNet takes (its four poolings
need H divisible by 16), and on the card every additive variant's trigger
runs the tiled kernels there.  C and the clean model are the PreActResNet
of tests/test_torch_variants.py (one block per stage) built with 8 classes
at 80 px, whose pooled map is 2 x 2; the generators are nf 8; the
detector is the ``original`` frequency model at 80 px.  Inputs are made
from a seed with numpy, the random draws are the JAX step's own (the
helpers of tests/_torch_helpers.py), and the weights cross with
``checkpoint.from_jax_params``.  The JAX side runs its Pallas kernels in
interpret mode; on the CPU the port runs the kernels' plain versions.

The train steps run on the K1/K2 route (``pallas_trigger``, the default);
input-aware, the variant with the most trigger calls (three K1 and two K2 a
step), also runs on the K3 and ATen routes.  The multilabel step takes bs
16, so that each of the 8 classes gets ceil(16/8) = 2 rows of the G-step's
targets; the other steps take bs 4 with target-class rows, so that the
C-step poisons some.  The models' initial parameters come from one jitted
``init`` a model, shared by the module's tests.

Tolerances, those of tests/test_torch_variants.py: losses 2e-4 absolute
plus 2e-4 relative, counts exactly, updated parameters (C and G) 5e-5
absolute, ops and generators 1e-5 absolute (sums over many samples, such as
the flow's gradient and the total variation, 1e-5 of their largest
magnitude).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (
    assert_state_close,
    jax_alternated_draws,
    jax_aug_draws,
    jax_inputaware_draws,
    jax_pair_sigmas,
    jax_sigma,
    jax_wanet_draws,
    nchw,
    nhwc,
    to_numpy_tree,
)
from combat_tpu_torch.checkpoint import from_jax_params
from test_torch_steps import PARAM_TOL, _assert_metrics
from test_torch_variants import OP_TOL, ROUTES, _assert_close_to_scale, _port_states, _rng

SIZE, K, NF = 80, 8, 8  # 80 px, celeba's 8 classes, generators at nf 8
BS, ML_BS = 4, 16
VALID = np.array([True, True, True, False])  # a padded last batch
POISONED = np.array([True, False, False, True])


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("COMBAT_PALLAS_INTERPRET", "1")
    torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _quick_compiles():
    """XLA compiles the JAX steps with most optimizations off (their
    compiles are most of this file's time), and as before after it."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _configs(bs=BS, route="pallas_trigger", **kw):
    """The celeba preset of both packages at 80 px, on ``route``."""
    from combat_tpu.config import Config as JaxConfig
    from combat_tpu.config import apply_dataset_preset as jax_preset

    from combat_tpu_torch.config import Config, apply_dataset_preset

    fused, lowfreq = ROUTES[route]
    size = dict(input_height=SIZE, input_width=SIZE, bs=bs, pallas_trigger=fused, pallas_lowfreq=lowfreq, **kw)
    jcfg = jax_preset(JaxConfig(dataset="celeba", synthetic_data=True)).replace(**size)
    cfg = apply_dataset_preset(Config(dataset="celeba", device="cpu", synthetic_data=True)).replace(**size)
    assert jcfg.num_classes == cfg.num_classes == K
    return jcfg, cfg


def _batch(seed, n=BS, labels=None):
    x = _rng(seed).uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)
    y = np.array([0, 0, 3, 5], np.int32) if labels is None else labels  # target-class rows, so some are poisoned
    return x, y


def _jax_generator(kind, num_classes=K):
    from combat_tpu.models import generators as J

    return {"unet": J.UnetGenerator(nf=NF), "grid": J.GridGenerator(nf=NF), "mixed": J.MixedGenerator(nf=NF),
            "cunet": J.CUnetGenerator(num_classes=num_classes, nf=NF)}[kind]


def _port_generator(kind, num_classes=K):
    from combat_tpu_torch.models import generators as P

    return {"unet": P.UnetGenerator(nf=NF), "grid": P.GridGenerator(nf=NF), "mixed": P.MixedGenerator(nf=NF),
            "cunet": P.CUnetGenerator(num_classes=num_classes, nf=NF)}[kind]


def _init(module, seeds, size=SIZE, extra=()):
    """A module's initial variables (numpy) for each of ``seeds``, from one
    jitted ``init``."""
    sample = jnp.zeros((1, size, size, 3))
    init = jax.jit(lambda k: module.init({"params": k, "dropout": k}, sample, *extra))
    return [to_numpy_tree(init(jax.random.key(seed))) for seed in seeds]


@functools.lru_cache(maxsize=None)
def _weights(kind=None):
    """The initial variables of C, G of ``kind``, the clean model and the
    detector, made once per module (C, the clean model and the detector
    once for every kind)."""
    from combat_tpu.models.frequency import FrequencyModel as JaxFrequency
    from combat_tpu.models.preact_resnet import PreActResNet as JaxPreAct

    if kind is None:
        (C, cm), (nf,) = _init(JaxPreAct([1, 1, 1, 1], K), (0, 2)), _init(JaxFrequency(num_classes=2), (3,))
        return dict(C=C, cm=cm, nf=nf)
    extra = (jnp.zeros((1,), jnp.int32),) if kind == "cunet" else ()
    return dict(_weights(), G=_init(_jax_generator(kind), (1,), extra=extra)[0])


def _models(kind):
    """JAX states and the port's models from the same weights."""
    from combat_tpu.models.frequency import FrequencyModel as JaxFrequency
    from combat_tpu.models.preact_resnet import PreActResNet as JaxPreAct
    from combat_tpu.train import FrozenModel, multistep_lr, sgd_torch
    from combat_tpu.train import TrainState as JaxTrainState

    from combat_tpu_torch.models import FrequencyModel, PreActResNet

    w = _weights(kind)
    tx = sgd_torch(multistep_lr(0.01, (100,), 0.1, 10))
    C, G, F = JaxPreAct([1, 1, 1, 1], K), _jax_generator(kind), JaxFrequency(num_classes=2)

    def state(module, v):
        return JaxTrainState.create(apply_fn=module.apply, params=v["params"], tx=tx,
                                    batch_stats=v.get("batch_stats", {}))

    def frozen(module, v):
        return FrozenModel(params=v["params"], batch_stats=v.get("batch_stats", {}), apply_fn=module.apply)

    j = dict(C=C, G=G, sC=state(C, w["C"]), sG=state(G, w["G"]), cm=frozen(C, w["cm"]), nf=frozen(F, w["nf"]))

    def load(module, variables, k):
        module.load_state_dict(from_jax_params(variables, k))
        return module

    port = dict(
        C=load(PreActResNet((1, 1, 1, 1), K, SIZE), w["C"], "preactresnet18"),
        G=load(_port_generator(kind), w["G"], kind),
        cm=load(PreActResNet((1, 1, 1, 1), K, SIZE), w["cm"], "preactresnet18"),
        nf=load(FrequencyModel(num_classes=2, input_size=SIZE), w["nf"], "frequency"),
    )
    return j, port


def _port_batch(*arrays):
    """NHWC images to NCHW tensors, labels to int64, masks to bool."""
    return tuple(nchw(a) if a.ndim == 4 else torch.from_numpy(a).long() if a.dtype == np.int32
                 else torch.from_numpy(a) for a in arrays)


def _run_train_step(variant, kind, route, batch, draws_fn, key, bs=BS):
    """One step of the JAX variant and of the port's from the same weights
    and draws; the metrics, C and G after the step, held to each other."""
    import combat_tpu.train.variants as jv

    import combat_tpu_torch.train.variants as pv

    jcfg, cfg = _configs(bs, route)
    j, port = _models(kind)
    make = f"make_{variant}_train_step"
    sC, sG, ref = jax.jit(getattr(jv, make)(jcfg, j["C"], j["G"]))(j["sC"], j["sG"], j["cm"], j["nf"], batch, key)
    stateC, stateG, cm, nf = _port_states(port)
    draws = draws_fn(key, cfg, bs)
    got = getattr(pv, make)(cfg, port["C"], port["G"])(stateC, stateG, cm, nf, _port_batch(*batch), draws=draws)
    _assert_metrics(got, ref)
    assert (stateC.step, stateG.step) == (int(sC.step), int(sG.step)) == (1, 1)
    assert_state_close(port["C"].state_dict(), from_jax_params(to_numpy_tree(sC.variables), "preactresnet18"),
                       **PARAM_TOL)
    assert_state_close(port["G"].state_dict(), from_jax_params(to_numpy_tree(sG.variables), kind),
                       **PARAM_TOL)
    return got, draws


def _poisons_a_row(draws, y, target=0):
    return bool((draws.poison & torch.from_numpy(y == target)).any())


# --------------------------------------------------------------------------
# train steps at 80 px
# --------------------------------------------------------------------------


def test_wanet_step_at_80px_matches_jax():
    """The flow upsampled from 2 x 2 to 80 x 80, the identity grid at 80 px."""
    x, y = _batch(20)
    got, draws = _run_train_step("wanet", "grid", "pallas_trigger", (x, y), jax_wanet_draws, jax.random.key(21))
    assert _poisons_a_row(draws, y) and float(got["loss_grad_l2"]) > 0.0


@pytest.mark.parametrize("route", list(ROUTES))
def test_inputaware_step_at_80px_matches_jax(route):
    """Three triggers a step (K1 x3, K2 x2 on the K1/K2 route), G's gradient
    from two streams."""
    x, y = _batch(22)
    x2 = _rng(23).uniform(-1, 1, x.shape).astype(np.float32)
    got, draws = _run_train_step("inputaware", "unet", route, (x, y, x2), jax_inputaware_draws, jax.random.key(24))
    assert _poisons_a_row(draws, y) and 0.0 <= float(got["cross_correct"]) <= BS


def test_imperceptible_step_at_80px_matches_jax():
    """The total variation of the 80 px triggered batch, through K2."""
    x, y = _batch(25)
    got, draws = _run_train_step("imperceptible", "unet", "pallas_trigger", (x, y), jax_alternated_draws,
                                 jax.random.key(26))
    assert _poisons_a_row(draws, y) and float(got["loss_tv"]) > 0.0


def test_multilabel_step_at_80px_matches_jax():
    """bs 16 over 8 classes: the G-step's targets are two rows a class."""
    from combat_tpu_torch.train.variants import multilabel_targets

    assert multilabel_targets(ML_BS, K, "cpu").tolist() == [i // 2 for i in range(ML_BS)]
    x, y = _batch(27, n=ML_BS, labels=_rng(28).integers(0, K, ML_BS).astype(np.int32))
    _, draws = _run_train_step("multilabel", "cunet", "pallas_trigger", (x, y), jax_alternated_draws,
                               jax.random.key(29), bs=ML_BS)
    assert bool(draws.poison.any())


@pytest.mark.parametrize("bs,num_classes", [(16, 8), (128, 8), (13, 8), (32, 10), (7, 10), (128, 10)])
def test_multilabel_targets_at_8_and_10_classes(bs, num_classes):
    """Row i's target ``min(i // ceil(bs/K), K-1)`` (the JAX step's form),
    every class below K reached in order, for celeba's K 8 and
    imagenet10's K 10."""
    from combat_tpu_torch.train.variants import multilabel_targets

    ps = -(-bs // num_classes)
    expected = np.minimum(np.arange(bs) // ps, num_classes - 1)
    got = multilabel_targets(bs, num_classes, "cpu")
    assert got.tolist() == expected.tolist() and got.dtype == torch.int64
    assert got.max() < num_classes and (torch.diff(got) >= 0).all()


# --------------------------------------------------------------------------
# eval and victim steps at 80 px
# --------------------------------------------------------------------------


def _eval_inputs(seed, pair=False, labels=None):
    """(JAX batch, port batch): x, y[, x2], valid."""
    x, y = _batch(seed, labels=labels)
    arrays = (x, y) + ((_rng(seed + 1).uniform(-1, 1, x.shape).astype(np.float32),) if pair else ()) + (VALID,)
    return arrays, _port_batch(*arrays)


def _jax_eval(variant, kind, jcfg, batch, key, victim=False):
    """The JAX variant eval step's metrics, and the port's models on the
    same weights."""
    import combat_tpu.train.variants as jv

    j, port = _models(kind)
    name = f"make_{variant}_victim_eval_step" if victim else f"make_{variant}_eval_step"
    step = jax.jit(getattr(jv, name)(jcfg, j["C"], j["G"]))
    args = (j["sC"].variables, j["sG"].params) + (() if victim else (j["cm"], j["nf"]))
    return step(*args, batch, key), port


def test_wanet_eval_step_at_80px_matches_jax():
    from combat_tpu_torch.train.variants import make_wanet_eval_step

    jcfg, cfg = _configs()
    jbatch, batch = _eval_inputs(40)
    ref, port = _jax_eval("wanet", "grid", jcfg, jbatch, jax.random.key(41))
    _, _, cm, nf = _port_states(port)
    got = make_wanet_eval_step(cfg, port["C"], port["G"])(cm, nf, batch)
    _assert_metrics(got, ref)
    assert float(got["clean_sample"]) == 3.0


def test_inputaware_eval_step_at_80px_matches_jax():
    from combat_tpu_torch.train.variants import make_inputaware_eval_step

    jcfg, cfg = _configs()
    jbatch, batch = _eval_inputs(42, pair=True)
    key = jax.random.key(43)
    ref, port = _jax_eval("inputaware", "unet", jcfg, jbatch, key)
    _, _, cm, nf = _port_states(port)
    got = make_inputaware_eval_step(cfg, port["C"], port["G"])(cm, nf, batch, draws=jax_pair_sigmas(key, cfg, 3))
    _assert_metrics(got, ref)


def test_multilabel_eval_step_over_8_classes_at_80px_matches_jax():
    """Eight class passes a batch, each with its own sigma (``fold_in(key,
    ci)``); every pass counts the valid rows of the other classes."""
    from combat_tpu_torch.train.variants import make_multilabel_eval_step

    jcfg, cfg = _configs()
    labels = np.array([0, 3, 7, 5], np.int32)
    jbatch, batch = _eval_inputs(45, labels=labels)
    key = jax.random.key(46)
    ref, port = _jax_eval("multilabel", "cunet", jcfg, jbatch, key)
    _, _, cm, nf = _port_states(port)
    sigmas = torch.stack([jax_sigma(jax.random.fold_in(key, ci), cfg.sigma) for ci in range(K)])
    got = make_multilabel_eval_step(cfg, port["C"], port["G"])(cm, nf, batch, sigma_draws=sigmas)
    _assert_metrics(got, ref)
    assert float(got["bd_sample"]) == sum(float((labels[VALID] != ci).sum()) for ci in range(K)) == 3 * K - 3


def test_wanet_victim_train_step_at_80px_matches_jax():
    import combat_tpu.train.variants as jv

    from combat_tpu_torch.train import TrainState, multistep_lr
    from combat_tpu_torch.train.variants import make_wanet_victim_train_step

    jcfg, cfg = _configs()
    j, port = _models("grid")
    x, y = _batch(47)
    key = jax.random.key(48)
    sC, ref = jax.jit(jv.make_wanet_victim_train_step(jcfg, j["C"], j["G"]))(j["sC"], j["sG"].params,
                                                                            (x, y, POISONED), key)
    stateC = TrainState(port["C"], multistep_lr(0.01, (100,), 0.1, 10))
    draws = jax_aug_draws(jax.random.split(key, 2)[0], BS, cfg.random_crop, float(cfg.random_rotation))
    got = make_wanet_victim_train_step(cfg, port["C"], port["G"])(stateC, _port_batch(x, y, POISONED), draws=draws)
    _assert_metrics(got, ref)
    assert stateC.step == int(sC.step) == 1
    assert_state_close(port["C"].state_dict(), from_jax_params(to_numpy_tree(sC.variables), "preactresnet18"),
                       **PARAM_TOL)


def test_inputaware_victim_eval_step_at_80px_matches_jax():
    from combat_tpu_torch.train.variants import make_inputaware_victim_eval_step

    jcfg, cfg = _configs()
    jbatch, batch = _eval_inputs(51, pair=True)
    key = jax.random.key(52)
    ref, port = _jax_eval("inputaware", "unet", jcfg, jbatch, key, victim=True)
    got = make_inputaware_victim_eval_step(cfg, port["C"], port["G"])(batch, draws=jax_pair_sigmas(key, cfg, 2))
    _assert_metrics(got, ref)


# --------------------------------------------------------------------------
# generators and the warp at celeba's 64 px and imagenet10's 224 px
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _generator_weights(kind, num_classes):
    """G's initial variables, made at 32 px: no parameter's shape depends
    on the image size (the flow head pools globally)."""
    extra = (jnp.zeros((1,), jnp.int32),) if kind == "cunet" else ()
    return _init(_jax_generator(kind, num_classes), (5,), 32, extra)[0]


@pytest.mark.parametrize("kind,size,num_classes", [
    ("grid", 64, 0), ("grid", 224, 0), ("mixed", 64, 0), ("mixed", 224, 0), ("unet", 64, 0), ("unet", 224, 0),
    ("cunet", 64, 8), ("cunet", 64, 10), ("cunet", 224, 8), ("cunet", 224, 10),
])
def test_generator_at_64_and_224px_matches_flax(kind, size, num_classes):
    """One forward at bs 1 with converted weights; the class-conditional G
    with an 8- or 10-wide one-hot label map."""
    jm, port = _jax_generator(kind, num_classes), _port_generator(kind, num_classes)
    variables = _generator_weights(kind, num_classes)
    port.load_state_dict(from_jax_params(variables, kind))
    x = _rng(size + num_classes).uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    label = np.array([num_classes - 1], np.int32)
    j_args = (jnp.asarray(label),) if kind == "cunet" else ()
    ref = jax.jit(lambda v, a: jm.apply(v, a, *j_args))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(nchw(x), *((torch.from_numpy(label).long(),) if kind == "cunet" else ()))
    refs, gots = (ref, got) if kind == "mixed" else ((ref,), (got,))
    for r, g in zip(refs, gots):
        r = np.asarray(r).transpose(0, 3, 1, 2)
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, **OP_TOL)


@pytest.mark.parametrize("dataset", ["celeba", "imagenet10"])
@pytest.mark.parametrize("kind", ["grid", "mixed", "unet", "cunet"])
def test_generator_parameter_counts_at_celeba_and_imagenet10(dataset, kind):
    """Full width (nf 64), as each package's ``get_generator`` builds it
    from the dataset's preset: the flow head's ``s`` and the label map's
    8 or 10 classes."""
    from combat_tpu.config import Config as JaxConfig
    from combat_tpu.config import apply_dataset_preset as jax_preset
    from combat_tpu.models.registry import get_generator as jax_generator

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_generator

    jcfg = jax_preset(JaxConfig(dataset=dataset))
    cfg = apply_dataset_preset(Config(dataset=dataset, device="cpu"))
    h = jcfg.input_height
    jm = jax_generator(jcfg, kind)
    extra = (jnp.zeros((1,), jnp.int32),) if kind == "cunet" else ()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, h, h, 3)), *extra))
    ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    port = get_generator(cfg, kind)
    assert sum(p.numel() for p in port.parameters()) == ref
    if kind == "cunet":
        assert port.num_classes == jcfg.num_classes == cfg.num_classes


@pytest.mark.parametrize("size", [64, 224])
def test_warp_and_total_variation_at_64_and_224px_match_jax(size):
    """WaNet's warp from a 2 x 2 flow at the image size, part by part: the
    bicubic upsample of the flow and the clamped blend with the identity
    grid against JAX's, then the sampling on the port's grid against JAX's
    ``grid_sample`` on that grid, and the gradient in the flow through the
    whole warp; then imperceptible's total variation.

    The warp end to end is not held to 1e-5 here: the two packages'
    identity grids (``linspace``) differ by one float32 rounding, 1.8e-7,
    which the sampling scales by (W - 1) / 2 pixels and by the difference
    of neighbouring pixels (up to 2 in this uniform noise): 2.2e-5 at 64 px
    and 8.9e-5 at 224 px (5.5e-6 at 32 px).  In the gradient, a rounding
    that moves a sample across a pixel boundary changes its grid gradient
    by a finite step (the bilinear weights' kink): at 224 px a few of the
    50,176 samples do, and the flow's gradient moves by up to 27 of ~140.
    So each part runs on the same grid, and the gradient is pulled back
    through the two parts from the same cotangent."""
    from combat_tpu.attack.triggers import identity_grid as jax_identity
    from combat_tpu.ops.image import grid_sample as jax_grid_sample
    from combat_tpu.ops.image import resize2d as jax_resize
    from combat_tpu.ops.image import total_variation as jax_tv

    from combat_tpu_torch.attack.triggers import identity_grid, warp_flow, warp_grid
    from combat_tpu_torch.ops.image import grid_sample, total_variation

    jax_id = np.asarray(jax_identity(size, size))
    np.testing.assert_allclose(identity_grid(size, size).numpy(), jax_id, **OP_TOL)
    x = _rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    flow = np.tanh(_rng(size + 1).normal(0, 2, (2, 2, 2, 2))).astype(np.float32)  # NHWC (B, s, s, 2)
    g = _rng(size + 2).normal(size=(2, size, size, 3)).astype(np.float32)

    flow_up = warp_flow(nchw(flow), size, size)
    jax_up = np.asarray(jax_resize(jnp.asarray(flow), (size, size), method="bicubic", align_corners=True))
    np.testing.assert_allclose(flow_up.numpy(), jax_up, **OP_TOL)
    grid = warp_grid(flow_up, 0.15)
    np.testing.assert_allclose(grid.numpy(), np.clip(jax_id[None] * 0.85 + jax_up * 0.15, -1.0, 1.0), **OP_TOL)
    ref = np.asarray(jax_grid_sample(jnp.asarray(x), jnp.asarray(grid.numpy()), align_corners=True))
    np.testing.assert_allclose(nhwc(grid_sample(nchw(x), grid)), ref, **OP_TOL)


    # the gradient, part by part on the port's grid: the sampling's in the
    # grid, then the grid's in the flow, pulled back from the same cotangent
    _, sample_vjp = jax.vjp(lambda gr: jax_grid_sample(jnp.asarray(x), gr, align_corners=True),
                            jnp.asarray(grid.numpy()))
    (ref_gg,) = sample_vjp(jnp.asarray(g))
    gt = grid.clone().requires_grad_()
    (got_gg,) = torch.autograd.grad(grid_sample(nchw(x), gt), gt, grad_outputs=nchw(g))
    # off a pixel centre: on one (the clamped samples at the border), torch's
    # floor-based backward and JAX's hat form take other subgradients
    # (tests/test_torch_variants.py), and the clamp zeroes them in the warp
    f = (grid.numpy().astype(np.float64) + 1.0) / 2.0 * (size - 1)
    off_centre = np.abs(f - np.round(f)) > 1e-4
    assert off_centre.mean() > 0.99
    _assert_close_to_scale(got_gg.numpy()[off_centre], np.asarray(ref_gg)[off_centre])
    _, grid_vjp = jax.vjp(lambda fl: jnp.clip(jnp.asarray(jax_id)[None] * 0.85 + jax_resize(
        fl, (size, size), method="bicubic", align_corners=True) * 0.15, -1.0, 1.0), jnp.asarray(flow))
    (ref_gf,) = grid_vjp(ref_gg)
    ft = nchw(flow).requires_grad_()
    (got_gf,) = torch.autograd.grad(warp_grid(warp_flow(ft, size, size), 0.15), ft,
                                    grad_outputs=torch.from_numpy(np.array(ref_gg)))
    _assert_close_to_scale(nhwc(got_gf), np.asarray(ref_gf))  # sums over size x size samples
    _assert_close_to_scale(total_variation(nchw(x)).numpy(), np.asarray(jax_tv(jnp.asarray(x))))
