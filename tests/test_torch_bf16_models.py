"""``--compute_dtype bfloat16`` (and ``float16``): each ported model's forward
against the JAX package's mixed-precision recipe, the dtype of every
intermediate against Flax's, and the WaNet grid under a bfloat16 flow.

The JAX side switches its process-wide compute dtype with
``combat_tpu.models.layers.set_compute_dtype`` inside :func:`jax_compute_dtype`,
which restores float32 however the test ends: Flax reads the dtype when a
model is traced, so a leak would turn the worker's later JAX tests into
bfloat16 ones without an error.

Outputs are held by the gap criterion of ``combat_tpu_torch/utils/gap.py``
(its docstring has the constants and the ratios measured here), with the
JAX package's float32 and low-precision runs as the reference.

A wrong recipe, BatchNorm returning its input's bfloat16 (what
``torch.autocast`` does on CUDA), passes every gap test here: in
PreActResNet the BatchNorm output goes through a ReLU into a convolution
that casts it to bfloat16 anyway (the logits are bit-identical), and in
ResNet18 (b) on the logits moves only from 0.52 to 0.78.  No constant
separates the two recipes, so the dtype map below is the discriminating
test: it fails on every BatchNorm of PreActResNet18, ResNet18 and the
detector under that recipe.
"""

import contextlib
import ctypes
import gc
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from _torch_helpers import nchw, nhwc, to_numpy_tree
from combat_tpu_torch.checkpoint import from_jax_params
from combat_tpu_torch.utils import gap

TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


@contextlib.contextmanager
def jax_compute_dtype(name: str):
    """The JAX package computes in ``name`` inside the block, float32 after."""
    from combat_tpu.models.layers import set_compute_dtype

    set_compute_dtype(name)
    try:
        yield
    finally:
        set_compute_dtype("float32")


def release_memory() -> None:
    """Hand the heap that the worker's tests freed (JAX compiles, torch runs)
    back to the system: a test session's worker otherwise keeps it (1.2 GB
    of 2.4 after the steps of tests/test_torch_bf16_steps.py and two other
    step files)."""
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:  # not glibc
        pass


@contextlib.contextmanager
def one_torch_thread():
    """torch runs on one thread inside the block (the suite's workers share
    the machine's cores), and on as many as before after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _float32_after():
    """No test of these files leaves the JAX package in low precision."""
    from combat_tpu.models.layers import compute_dtype

    with one_torch_thread():
        release_memory()
        yield
        release_memory()
    assert compute_dtype() is None


def assert_gap(what: str, port_lo, port_f32, jax_lo, jax_f32, checks: str = "abc") -> None:
    """The gap criterion's ``checks`` (a subset of "abc"), the JAX
    package's runs as the reference."""
    failure = gap.gap_failure(what, port_lo, port_f32, jax_lo, jax_f32, checks)
    assert failure is None, failure


def _rng(seed):
    return np.random.default_rng(seed)


# --------------------------------------------------------------------------
# The models: (JAX module, port constructor, converter kind, input)
# --------------------------------------------------------------------------


def _family(name, dtype=None):
    from combat_tpu.models import generators as JG
    from combat_tpu.models.frequency import FrequencyModel as JaxFrequency
    from combat_tpu.models.preact_resnet import PreActResNet as JaxPreAct
    from combat_tpu.models.resnet import ResNet as JaxResNet

    from combat_tpu_torch.models import FrequencyModel, PreActResNet, ResNet, set_compute_dtype
    from combat_tpu_torch.models import generators as PG

    x = _rng(0).uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    jax_module, make, kind, x = {
        "preactresnet18": (JaxPreAct([2, 2, 2, 2], 10), lambda: PreActResNet((2, 2, 2, 2), 10), "preactresnet18", x),
        "resnet18": (JaxResNet([2, 2, 2, 2], 10), lambda: ResNet((2, 2, 2, 2), 10), "resnet", x),
        "unet": (JG.UnetGenerator(nf=16), lambda: PG.UnetGenerator(nf=16), "unet", x),
        "unet_bk": (JG.UnetGeneratorBK(nf=16), lambda: PG.UnetGeneratorBK(nf=16), "unet_bk", x),
        "grid": (JG.GridGenerator(nf=16), lambda: PG.GridGenerator(nf=16), "grid", x),
        "mixed": (JG.MixedGenerator(nf=16), lambda: PG.MixedGenerator(nf=16), "mixed", x),
        "cunet": (JG.CUnetGenerator(nf=16), lambda: PG.CUnetGenerator(nf=16), "cunet", x),
        "fixed": (JG.FixedTriggerGenerator(), lambda: PG.FixedTriggerGenerator(), "fixed", x),
        # the detector reads DCT coefficients of uint8 images: O(100)
        "frequency": (JaxFrequency(num_classes=2), lambda: FrequencyModel(num_classes=2), "frequency", x * 100),
    }[name]
    return jax_module, lambda: set_compute_dtype(make(), dtype), kind, x


LABELS = np.array([0, 4, 9, 1, 2, 3, 5, 7], np.int32)


def _extra(name, framework):
    if name != "cunet":
        return ()
    return (jnp.asarray(LABELS),) if framework == "jax" else (torch.from_numpy(LABELS).long(),)


def _as_nchw(a):
    a = np.asarray(a, np.float32)
    if a.ndim == 4:
        return a.transpose(0, 3, 1, 2)
    return a


def _forwards(name, low: str):
    """Outputs (as NCHW numpy lists; the JAX flow field's (B, s, s, 2) as
    the port's (B, 2, s, s)) of the JAX model in float32 and in ``low``, and
    of the port's in both, from one set of converted weights; and the raw
    low-precision outputs of both."""
    jm, _, kind, x = _family(name)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x), *_extra(name, "jax"))
    sd = from_jax_params(to_numpy_tree(variables), kind)

    def jax_out():  # a jit of its own each time: traced in the compute dtype set now
        out = jax.jit(jm.apply)(variables, jnp.asarray(x), *_extra(name, "jax"))
        out = out if isinstance(out, tuple) else (out,)
        return [_as_nchw(o) for o in out], out

    def port_out(dtype):
        model = _family(name, dtype)[1]()
        model.load_state_dict(sd)
        model.eval()
        with torch.no_grad():
            out = model(nchw(x), *_extra(name, "torch"))
        out = out if isinstance(out, tuple) else (out,)
        return [o.detach().float().numpy() for o in out], out

    jax_f32, _ = jax_out()
    with jax_compute_dtype(low):
        jax_lo, jax_raw = jax_out()
    port_f32, _ = port_out(None)
    port_lo, port_raw = port_out(TORCH_DTYPES[low])
    return jax_f32, jax_lo, port_f32, port_lo, (port_raw, jax_raw)


@pytest.mark.parametrize("name", ["preactresnet18", "resnet18", "unet", "unet_bk", "grid", "mixed", "cunet",
                                  "frequency"])
def test_bf16_forward_matches_the_jax_recipe(name):
    """Eval forwards of every ported model in bfloat16, held by the gap
    criterion; the outputs come out in the JAX recipe's dtype (the
    classifiers' and the detector's logits, the generators' tanh, bfloat16;
    UnetGeneratorBK's ``noise * 0.08 + x`` promotes to float32)."""
    jax_f32, jax_lo, port_f32, port_lo, (port_raw, jax_raw) = _forwards(name, "bfloat16")
    assert _dtypes(port_raw) == _dtypes(jax_raw) and "bfloat16" in _dtypes(port_raw) + ["bfloat16"] * (
        name == "unet_bk")
    for i, (pl, pf, jl, jf) in enumerate(zip(port_lo, port_f32, jax_lo, jax_f32)):
        assert pl.shape == jl.shape
        assert_gap(f"{name} output {i}", pl, pf, jl, jf)


def test_float16_forward_matches_the_jax_recipe():
    """float16 takes the same path (``set_compute_dtype`` takes any dtype
    name in the JAX package); one model forward holds it."""
    jax_f32, jax_lo, port_f32, port_lo, (port_raw, jax_raw) = _forwards("preactresnet18", "float16")
    assert port_raw[0].dtype == torch.float16 and jax_raw[0].dtype == jnp.float16
    assert_gap("preactresnet18 float16 logits", port_lo[0], port_f32[0], jax_lo[0], jax_f32[0])


def test_fixed_trigger_is_float32_in_either_dtype():
    """The fixed trigger is a parameter with no convolution: float32 under
    bfloat16 compute, as in the JAX package."""
    _, jax_lo, port_f32, port_lo, (port_raw, jax_raw) = _forwards("fixed", "bfloat16")
    assert port_raw[0].dtype == torch.float32 and jax_raw[0].dtype == jnp.float32
    np.testing.assert_array_equal(port_lo[0], port_f32[0])
    np.testing.assert_allclose(port_lo[0], jax_lo[0], atol=1e-6)


# --------------------------------------------------------------------------
# The dtype of every intermediate, against Flax's capture_intermediates
# --------------------------------------------------------------------------


def _port_name(path):
    """A Flax module path -> the port's module name, or None where the port
    has no module (InstanceNorm, a function there; Dropout)."""
    out = []
    for part in path:
        if part.startswith("layer") and "_" in part:
            out.extend(part.split("_"))
        elif part == "shortcut":
            out.extend(["shortcut", "0"])
        elif part == "shortcut_conv":
            out.extend(["shortcut", "0"])
        elif part == "shortcut_bn":
            out.extend(["shortcut", "1"])
        elif part.startswith(("bn", "upbn")) and path[0] in ("enc", "dec"):
            return None  # InstanceNorm
        elif part.startswith("Dropout"):
            return None
        else:
            out.append(part)
    return ".".join(out)


def _dtypes(tree):
    return [str(a.dtype).replace("torch.", "") for a in jax.tree.leaves(tree)]


@pytest.mark.parametrize("name", ["preactresnet18", "resnet18", "unet", "frequency"])
@pytest.mark.parametrize("train", [False, True])
def test_bf16_intermediate_dtypes_match_flax(name, train, monkeypatch):
    """Every module output of the port (forward hooks) has the dtype of the
    Flax submodule of the same name; InstanceNorm, a function in the port,
    is held in call order.  Train mode runs BatchNorm on batch statistics."""
    import combat_tpu_torch.models.generators as PG

    jm, make, kind, x = _family(name, torch.bfloat16)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))
    mutable = ["intermediates", "batch_stats"] if train and "batch_stats" in variables else ["intermediates"]
    with jax_compute_dtype("bfloat16"):
        _, state = jax.jit(partial(jm.apply, train=train, capture_intermediates=True, mutable=mutable))(
            variables, jnp.asarray(x), rngs={"dropout": jax.random.key(1)})
    flat = traverse_util.flatten_dict(state["intermediates"])
    flax_by_name, flax_norms = {}, []
    for path, value in flat.items():
        assert path[-1] == "__call__"
        port = _port_name(path[:-1])
        if port is None and path[-2].startswith(("bn", "upbn")):
            flax_norms.append(_dtypes(value))
        elif port is not None:
            flax_by_name[port] = _dtypes(value)

    model = make()
    model.load_state_dict(from_jax_params(to_numpy_tree(variables), kind))
    model.train(train)
    seen, norms = {}, []
    hooks = [m.register_forward_hook(lambda mod, inp, out, n=n: seen.__setitem__(n, _dtypes(out)))
             for n, m in model.named_modules()]
    norm = PG.instance_norm
    monkeypatch.setattr(PG, "instance_norm", lambda t: (lambda o: norms.append(_dtypes(o)) or o)(norm(t)))
    with torch.no_grad():
        model(nchw(x))
    for h in hooks:
        h.remove()

    from combat_tpu_torch.models import BatchNorm2d, Conv2d, Linear

    weighted = {n for n, m in model.named_modules() if isinstance(m, (Conv2d, Linear, BatchNorm2d))} | {""}
    assert weighted <= set(flax_by_name), sorted(weighted - set(flax_by_name))
    mismatched = {n: (seen[n], d) for n, d in flax_by_name.items() if n in seen and seen[n] != d}
    assert not mismatched, mismatched
    assert norms == flax_norms and (name != "unet" or len(norms) == 14)
    assert "bfloat16" in sum(flax_by_name.values(), []) and (
        name in ("unet",) or "float32" in sum(flax_by_name.values(), []))


# --------------------------------------------------------------------------
# compute_dtype names; the WaNet grid under a bfloat16 flow
# --------------------------------------------------------------------------


def test_compute_dtype_names():
    from combat_tpu_torch.cli.common import setup_device
    from combat_tpu_torch.config import Config, apply_dataset_preset, from_args
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator, parse_compute_dtype

    assert [parse_compute_dtype(n) for n in ("float32", "f32", "", "bfloat16", "float16")] == [
        None, None, None, torch.bfloat16, torch.float16]
    with pytest.raises(ValueError, match="bfloat16"):
        parse_compute_dtype("int8")
    with pytest.raises(ValueError, match="float16"):
        setup_device(from_args(["--device", "cpu", "--compute_dtype", "float64"]))
    assert setup_device(from_args(["--device", "cpu", "--compute_dtype", "bfloat16"])).type == "cpu"
    cfg = apply_dataset_preset(Config(device="cpu", compute_dtype="bfloat16"))
    for model in (get_classifier(cfg), get_generator(cfg), get_generator(cfg, "grid"), get_frequency_detector(cfg)):
        layers = [m for m in model.modules() if hasattr(m, "compute_dtype")]
        assert layers and all(m.compute_dtype == torch.bfloat16 for m in layers)
        assert all(p.dtype == torch.float32 for p in model.parameters())
    f32 = get_classifier(cfg.replace(compute_dtype="float32"))
    assert all(m.compute_dtype is None for m in f32.modules() if hasattr(m, "compute_dtype"))


def test_warp_grid_keeps_the_identity_in_float32_under_a_bf16_flow():
    """The grid is ``identity (f32) * (1 - r) + flow_up (bf16) * r``: float32
    by promotion, as ``combat_tpu/attack/triggers.py:92`` computes it, not
    rounded to bfloat16."""
    from combat_tpu.attack.triggers import identity_grid as jax_identity

    from combat_tpu_torch.attack.triggers import warp_grid

    flow_up = np.tanh(_rng(1).normal(0, 1, (2, 16, 12, 2))).astype(np.float32)
    for rescale in (1.0, 1.5):
        ref = jnp.clip(jax_identity(16, 12)[None] * (1.0 - rescale) + jnp.asarray(flow_up, jnp.bfloat16) * rescale,
                       -1.0, 1.0)
        got = warp_grid(torch.from_numpy(flow_up).to(torch.bfloat16), rescale)
        assert got.dtype == torch.float32 and ref.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0.0)


def test_warp_trigger_with_a_bf16_flow_matches_jax():
    """The whole warp from a bfloat16 flow (the grid generator's output):
    the bicubic resize rounds in bfloat16 on both sides, the grid and the
    sample are float32; held by the gap criterion against the float32 warp."""
    from combat_tpu.attack.triggers import warp_trigger as jax_warp

    from combat_tpu_torch.attack.triggers import warp_trigger

    x = _rng(2).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    flow = np.tanh(_rng(3).normal(0, 2, (2, 2, 2, 2))).astype(np.float32)  # NHWC (B, s, s, 2)

    def jax_fn(dtype):
        return np.asarray(jax_warp(jnp.asarray(x), jnp.asarray(flow, dtype), grid_rescale=1.0))

    def port_fn(dtype):
        out = warp_trigger(nchw(x), nchw(flow).to(dtype), grid_rescale=1.0)
        assert out.dtype == torch.float32
        return nhwc(out)

    assert_gap("warp_trigger", port_fn(torch.bfloat16), port_fn(torch.float32), jax_fn(jnp.bfloat16),
               jax_fn(jnp.float32))
