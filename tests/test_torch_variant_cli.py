"""The eight variant entry points on the CPU, with JAX blocked, at cifar10
(32 px, 10 classes) and celeba (64 px, 8 classes).

One subprocess a dataset (JAX, Flax, Optax, Orbax and ``combat_tpu``
blocked in ``sys.modules``, as in tests/test_torch_cli.py) runs the clean
classifier, the four variant generators and the four variant victims at a
tiny synthetic size, so that each epoch takes two full batches and a ragged
tail: 20 rows at bs 8 (8 + 8 + 4) at cifar10, 10 rows at bs 4 (4 + 4 + 2)
at celeba, whose 64 px full-width ResNet18 costs four times the
convolutions of a 32 px row.  The best-metric gates are opened, so every
run saves whatever its accuracy on its 4 or 2 test rows.  Each run's
checkpoint must hold the JAX package's keys for that entry point, which the
test derives from the JAX specs; each port spec must match its JAX spec.
Both datasets have their ``original`` detector in the repository, which the
generators load.  The subprocess sums up what the tests read of each
checkpoint and deletes it; the session's xdist workers share one subprocess
a dataset.
imagenet10's entry points (224 px) are too slow for this suite; they run on
the card (``chip_smoke.py``).
"""

import dataclasses
import importlib
import json
import os
import pathlib

import pytest
import torch
from filelock import FileLock

from test_torch_cli import _run

GENERATORS = ("wanet", "inputaware", "imperceptible", "multilabel")
ENTRIES = tuple(f"train_generator_{v}" for v in GENERATORS) + tuple(f"train_victim_{v}" for v in GENERATORS)
# dataset -> (rows of the synthetic train split, bs): two full batches and a ragged tail
SIZES = {"cifar10": (20, 8), "celeba": (10, 4)}
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


# Runs in the subprocess after every entry point: what the tests read of each
# checkpoint, then every checkpoint but the clean run's goes (1.4 GB a
# dataset); the multilabel victim's refusal test loads that one.
_SUMMARY = """
import hashlib, json, shutil
import torch


def digest(sd):
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].contiguous().numpy().tobytes())
    return h.hexdigest()


summary = {}
for entry, prefix in prefixes.items():
    p = torch.load(f"{ck}/{prefix}_clean/{dataset}/{dataset}_{prefix}_clean.pt", weights_only=True)
    s = summary[entry] = {
        "keys": sorted(p),
        "steps": [p["schedulerC"]["step"], p["scheduler_steps_per_epoch"], p["epoch_current"]],
        "finite": all(bool(torch.isfinite(v).all()) for g in ("netC", "netG") for v in p[g].values()
                      if v.is_floating_point()),
        "steps_G": p["schedulerG"]["step"] if "schedulerG" in p else None,
        "F_detector_loaded": p.get("F_detector_loaded"),
        "classes": p["netC"]["linear.bias"].shape[0],
        "netG_keys": sorted(p["netG"]),
        "netG": digest(p["netG"]),
        "label_map_in": p["netG"]["enc.conv0_1.weight"].shape[1],
        "grid_rescale": p.get("grid_rescale"),
    }
    if "mask" in p:
        s.update(mask=p["mask"].tolist(), pattern=[list(p["pattern"].shape), float(p["pattern"].min()),
                                                   float(p["pattern"].max())],
                 lr_G=p["optimizerG"]["param_groups"][0]["lr"], lr_C=p["optimizerC"]["param_groups"][0]["lr"],
                 best_cross_acc=p["best_cross_acc"])
    shutil.rmtree(f"{ck}/{prefix}_clean")
print("SUMMARY " + json.dumps(summary))
"""


def _run_every_entry_point(dataset, ck):
    """The clean classifier, then every entry point in order, in one
    subprocess with JAX blocked; (the checkpoints' summary, the output)."""
    rows, bs = SIZES[dataset]
    common = ["--device", "cpu", "--dataset", dataset, "--synthetic_data", "--synthetic_size", str(rows),
              "--bs", str(bs), "--n_iters", "1", "--checkpoints", str(ck)]
    code = (
        "import importlib, sys\n"
        "from combat_tpu_torch.cli import _alternated, _victim, train_clean_classifier\n"
        "_alternated.best_gate_attack = _victim.best_gate_clean = train_clean_classifier.best_gate_clean = "
        "lambda *a: True\n"
        "a = sys.argv[1:]\n"
        f"ck, dataset = {str(ck)!r}, {dataset!r}\n"
        f"prefixes = {({entry: prefix for entry, (prefix, _) in RUNS.items()})!r}\n"
    )
    code += "importlib.import_module('combat_tpu_torch.cli.train_clean_classifier').main(a + ['--saving_prefix', 'cl'])\n"
    for entry, (prefix, extra) in RUNS.items():
        code += (f"print('BEST {entry}', importlib.import_module('combat_tpu_torch.cli.{entry}')"
                 f".main(a + ['--saving_prefix', {prefix!r}] + {extra!r}))\n")
    proc = _run(code + _SUMMARY, *common, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(line for line in proc.stdout.splitlines() if line.startswith("SUMMARY "))
    return json.loads(line.split(" ", 1)[1]), proc.stdout


@pytest.fixture(scope="module", params=["cifar10", "celeba"])
def runs(request, tmp_path_factory):
    """(the dataset, the checkpoint root, each entry point's checkpoint
    summary, the output) of :func:`_run_every_entry_point` on the dataset
    of ``request.param``, made once a session: the session's xdist workers
    share it (a file lock in the session's base temporary directory),
    however they split this file's tests."""
    dataset = request.param
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        ck = tmp_path_factory.mktemp(f"variant_cli_{dataset}") / "ck"
        return (dataset, ck, *_run_every_entry_point(dataset, ck))
    shared = tmp_path_factory.getbasetemp().parent / f"variant_cli_{dataset}.json"
    with FileLock(f"{shared}.lock"):
        if not shared.is_file():
            ck = tmp_path_factory.mktemp(f"variant_cli_{dataset}") / "ck"
            shared.write_text(json.dumps([str(ck), *_run_every_entry_point(dataset, ck)]))
        ck, summary, out = json.loads(shared.read_text())
    return dataset, pathlib.Path(ck), summary, out


def _jax_spec(entry):
    """The JAX entry point's spec; the imperceptible victim is an alias of
    the base victim in both packages."""
    name = "train_victim" if entry == "train_victim_imperceptible" else entry
    return importlib.import_module(f"combat_tpu.cli.{name}").SPEC


def _expected_keys(entry, dataset):
    """The keys of the JAX package's checkpoint for ``entry`` on ``dataset``:
    the fixed keys of its run loop (``_alternated.payload_of`` or
    ``_victim.payload_of``), the best metrics its spec tracks, and its
    spec's extra keys."""
    import jax

    from combat_tpu.cli._alternated import BASE_BEST_KEYS
    from combat_tpu.config import Config, apply_dataset_preset

    spec = _jax_spec(entry)
    cfg = apply_dataset_preset(Config(dataset=dataset))
    cross = {"best_cross_acc"} if spec.track_cross else set()
    if entry.startswith("train_victim") and entry != "train_victim_multilabel":
        extra = spec.extra_ckpt(cfg) if spec.extra_ckpt else {}
        return VICTIM_KEYS | cross | set(extra)
    extra = spec.extra_ckpt(cfg, jax.random.key(0)) if spec.extra_ckpt else {}
    return ALTERNATED_KEYS | set(BASE_BEST_KEYS) | cross | set(extra)


@pytest.mark.parametrize("entry", ENTRIES)
def test_variant_cli_writes_the_jax_checkpoint_keys(runs, entry):
    dataset, _, summary, out = runs
    s = summary[entry]
    assert set(s["keys"]) == _expected_keys(entry, dataset)
    assert s["steps"] == [3, 3, 0]  # schedulerC's steps, steps a epoch (two batches and a tail), the epoch
    assert f"BEST {entry}" in out and s["finite"]  # netC and netG
    if "schedulerG" in s["keys"]:
        assert s["steps_G"] == 3 and s["F_detector_loaded"] is True


def test_variant_cli_extras(runs):
    """Input-aware: the mask, the pattern, G's lr of lr_C * 0.1 and the cross
    accuracy; WaNet: the grid rescale; the victims keep G as the generator
    run left it, and the multilabel victim continues training it; the
    models are sized from the dataset's preset (the classifier's classes,
    the conditional G's label map)."""
    dataset, _, summary, out = runs
    from combat_tpu_torch.config import Config, apply_dataset_preset

    cfg = apply_dataset_preset(Config(dataset=dataset))
    h, k = cfg.input_height, cfg.num_classes
    ia = summary["train_generator_inputaware"]
    mask = torch.zeros(h, h)
    mask[2:6, 2:6] = 0.1
    assert ia["mask"] == mask.tolist()
    (shape, low, high) = ia["pattern"]
    assert shape == [3, h, h] and 0.0 <= low <= high < 1.0
    assert ia["lr_G"] == pytest.approx(1e-3)
    assert ia["lr_C"] == pytest.approx(1e-2)
    assert 0.0 <= ia["best_cross_acc"] <= 100.0 and "Cross Acc:" in out
    assert summary["train_victim_wanet"]["grid_rescale"] == pytest.approx(0.15)
    for victim, generator in (("train_victim_wanet", "train_generator_wanet"),
                              ("train_victim_inputaware", "train_generator_inputaware"),
                              ("train_victim_imperceptible", "train_generator_imperceptible")):
        g, v = summary[generator], summary[victim]
        assert v["netG_keys"] == g["netG_keys"] and v["netG"] == g["netG"], victim
    ml, vml = summary["train_generator_multilabel"], summary["train_victim_multilabel"]
    assert ml["netG_keys"] == vml["netG_keys"] and ml["netG"] != vml["netG"]
    for entry in ENTRIES:
        assert summary[entry]["classes"] == k, entry
        assert summary[entry]["label_map_in"] == 64 + (k if entry.endswith("multilabel") else 0), entry


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
    dataset, ck, _, _ = runs
    from combat_tpu_torch.cli import train_victim_multilabel

    torch.set_num_threads(1)
    with pytest.raises(SystemExit, match="--load_checkpoint is required"):
        train_victim_multilabel.main(["--device", "cpu", "--dataset", dataset, "--synthetic_data",
                                      "--synthetic_size", "8", "--checkpoints", str(ck),
                                      "--load_checkpoint_clean", "cl"])
