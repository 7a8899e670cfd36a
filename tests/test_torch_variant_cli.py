"""The eight variant entry points on the CPU, with JAX blocked.

One subprocess (JAX, Flax, Optax, Orbax and ``combat_tpu`` blocked in
``sys.modules``, as in tests/test_torch_cli.py) runs the clean classifier,
the four variant generators and the four variant victims at a tiny
synthetic size: 20 rows at bs 8, so each epoch takes two full batches and a
ragged tail of 4.  The best-metric gates are opened, so every run saves
whatever its accuracy on 4 test rows.  Each run's checkpoint must hold the
JAX package's keys for that entry point, which the test derives from the
JAX specs; each port spec must match its JAX spec.
"""

import dataclasses
import importlib
import shutil

import pytest
import torch

from test_torch_cli import _run

GENERATORS = ("wanet", "inputaware", "imperceptible", "multilabel")
ENTRIES = tuple(f"train_generator_{v}" for v in GENERATORS) + tuple(f"train_victim_{v}" for v in GENERATORS)
# entry point -> (saving prefix, extra flags)
RUNS = {
    "train_generator_wanet": ("wanet", ["--load_checkpoint_clean", "cl"]),
    "train_generator_inputaware": ("ia", ["--load_checkpoint_clean", "cl"]),
    "train_generator_imperceptible": ("imp", ["--load_checkpoint_clean", "cl"]),
    "train_generator_multilabel": ("ml", ["--load_checkpoint_clean", "cl"]),
    "train_victim_wanet": ("vwanet", ["--load_checkpoint", "wanet_clean"]),
    "train_victim_inputaware": ("via", ["--load_checkpoint", "ia_clean"]),
    "train_victim_imperceptible": ("vimp", ["--load_checkpoint", "imp_clean"]),
    "train_victim_multilabel": ("vml", ["--load_checkpoint", "ml_clean", "--load_checkpoint_clean", "cl"]),
}
ALTERNATED_KEYS = {"netC", "schedulerC", "optimizerC", "netG", "schedulerG", "optimizerG", "clean_model",
                   "F_detector_loaded", "scheduler_steps_per_epoch", "epoch_current"}
VICTIM_KEYS = {"netC", "schedulerC", "optimizerC", "netG", "best_clean_acc", "best_bd_acc",
               "scheduler_steps_per_epoch", "epoch_current"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every entry point once, in order, in one subprocess with JAX blocked;
    yields the checkpoint root and the output, and deletes the checkpoints
    (1.4 GB) after the module's tests."""
    ck = tmp_path_factory.mktemp("variant_cli") / "ck"
    common = ["--device", "cpu", "--synthetic_data", "--synthetic_size", "20", "--bs", "8", "--n_iters", "1",
              "--checkpoints", str(ck)]
    code = (
        "import importlib, sys\n"
        "from combat_tpu_torch.cli import _alternated, _victim, train_clean_classifier\n"
        "_alternated.best_gate_attack = _victim.best_gate_clean = train_clean_classifier.best_gate_clean = "
        "lambda *a: True\n"
        "a = sys.argv[1:]\n"
    )
    code += "importlib.import_module('combat_tpu_torch.cli.train_clean_classifier').main(a + ['--saving_prefix', 'cl'])\n"
    for entry, (prefix, extra) in RUNS.items():
        code += (f"print('BEST {entry}', importlib.import_module('combat_tpu_torch.cli.{entry}')"
                 f".main(a + ['--saving_prefix', {prefix!r}] + {extra!r}))\n")
    proc = _run(code, *common, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    yield ck, proc.stdout
    shutil.rmtree(ck)


def _payload(ck, entry):
    prefix = RUNS[entry][0]
    return torch.load(ck / f"{prefix}_clean/cifar10/cifar10_{prefix}_clean.pt", weights_only=True)


def _jax_spec(entry):
    """The JAX entry point's spec; the imperceptible victim is an alias of
    the base victim in both packages."""
    name = "train_victim" if entry == "train_victim_imperceptible" else entry
    return importlib.import_module(f"combat_tpu.cli.{name}").SPEC


def _expected_keys(entry):
    """The keys of the JAX package's checkpoint for ``entry``: the fixed keys
    of its run loop (``_alternated.payload_of`` or ``_victim.payload_of``),
    the best metrics its spec tracks, and its spec's extra keys."""
    import jax

    from combat_tpu.cli._alternated import BASE_BEST_KEYS
    from combat_tpu.config import Config, apply_dataset_preset

    spec = _jax_spec(entry)
    cfg = apply_dataset_preset(Config())
    cross = {"best_cross_acc"} if spec.track_cross else set()
    if entry.startswith("train_victim") and entry != "train_victim_multilabel":
        extra = spec.extra_ckpt(cfg) if spec.extra_ckpt else {}
        return VICTIM_KEYS | cross | set(extra)
    extra = spec.extra_ckpt(cfg, jax.random.key(0)) if spec.extra_ckpt else {}
    return ALTERNATED_KEYS | set(BASE_BEST_KEYS) | cross | set(extra)


@pytest.mark.parametrize("entry", ENTRIES)
def test_variant_cli_writes_the_jax_checkpoint_keys(runs, entry):
    ck, out = runs
    payload = _payload(ck, entry)
    assert set(payload) == _expected_keys(entry)
    assert payload["schedulerC"]["step"] == payload["scheduler_steps_per_epoch"] == 3  # 8 + 8 + a tail of 4
    assert payload["epoch_current"] == 0 and f"BEST {entry}" in out
    for group in ("netC", "netG"):
        assert all(torch.isfinite(v).all() for v in payload[group].values() if v.is_floating_point())
    if "schedulerG" in payload:
        assert payload["schedulerG"]["step"] == 3 and payload["F_detector_loaded"] is True


def test_variant_cli_extras(runs):
    """Input-aware: the mask, the pattern, G's lr of lr_C * 0.1 and the cross
    accuracy; WaNet: the grid rescale; the victims keep G as the generator
    run left it, and the multilabel victim continues training it."""
    ck, out = runs
    ia = _payload(ck, "train_generator_inputaware")
    mask = torch.zeros(32, 32)
    mask[2:6, 2:6] = 0.1
    assert torch.equal(ia["mask"], mask)
    assert ia["pattern"].shape == (3, 32, 32) and 0.0 <= float(ia["pattern"].min()) <= float(ia["pattern"].max()) < 1.0
    assert ia["optimizerG"]["param_groups"][0]["lr"] == pytest.approx(1e-3)
    assert ia["optimizerC"]["param_groups"][0]["lr"] == pytest.approx(1e-2)
    assert 0.0 <= ia["best_cross_acc"] <= 100.0 and "Cross Acc:" in out
    assert _payload(ck, "train_victim_wanet")["grid_rescale"] == pytest.approx(0.15)
    for victim, generator in (("train_victim_wanet", "train_generator_wanet"),
                              ("train_victim_inputaware", "train_generator_inputaware"),
                              ("train_victim_imperceptible", "train_generator_imperceptible")):
        g, v = _payload(ck, generator)["netG"], _payload(ck, victim)["netG"]
        assert all(torch.equal(v[k], t) for k, t in g.items()), victim
    ml, vml = _payload(ck, "train_generator_multilabel")["netG"], _payload(ck, "train_victim_multilabel")["netG"]
    assert set(ml) == set(vml) and not all(torch.equal(ml[k], vml[k]) for k in ml)


@pytest.mark.parametrize("entry", ENTRIES)
def test_variant_spec_matches_jax(entry):
    port_module = importlib.import_module(f"combat_tpu_torch.cli.{entry}")
    if entry == "train_victim_imperceptible":
        base = importlib.import_module("combat_tpu_torch.cli.train_victim")
        assert port_module.run is base.run and port_module.main is base.main
        port_spec = base.SPEC
    else:
        port_spec = port_module.SPEC
    jax_spec = _jax_spec(entry)
    for f in dataclasses.fields(port_spec):
        ours, theirs = getattr(port_spec, f.name), getattr(jax_spec, f.name)
        if callable(ours) and f.name.startswith("make_"):
            assert ours.__name__ == theirs.__name__, f.name
        elif f.name == "extra_ckpt":
            assert (ours is None) == (theirs is None)
        else:
            assert ours == theirs, f.name
    assert {f.name for f in dataclasses.fields(port_spec)} == {f.name for f in dataclasses.fields(jax_spec)}


def test_variant_cli_help_without_jax():
    code = (
        "import runpy, sys\n"
        f"for entry in {ENTRIES!r}:\n"
        "    sys.argv = ['x', '--help']\n"
        "    try:\n"
        "        runpy.run_module('combat_tpu_torch.cli.' + entry, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, entry\n"
        "    print('HELP', entry)\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("usage: x") == len(ENTRIES) and "--pallas_trigger" in proc.stdout
    assert all(f"HELP {e}" in proc.stdout for e in ENTRIES)


def test_multilabel_victim_requires_the_generator_run(runs):
    ck, _ = runs
    from combat_tpu_torch.cli import train_victim_multilabel

    torch.set_num_threads(1)
    with pytest.raises(SystemExit, match="--load_checkpoint is required"):
        train_victim_multilabel.main(["--device", "cpu", "--synthetic_data", "--synthetic_size", "8",
                                      "--checkpoints", str(ck), "--load_checkpoint_clean", "cl"])
