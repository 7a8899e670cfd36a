"""Every entry point with ``--compute_dtype bfloat16`` on the CPU, with JAX
blocked, and checkpoints crossing between the dtypes.

One subprocess (JAX, Flax, Optax, Orbax and ``combat_tpu`` blocked in
``sys.modules``, as in tests/test_torch_cli.py) runs, at 20 rows and bs 8
with the best-metric gates opened (tests/test_torch_variant_cli.py): the
four stages of the main path in bfloat16, the eight variant entry points in
bfloat16, and the crossings: a bfloat16 generator on a float32 clean model,
a float32 victim of a bfloat16 generator, and a bfloat16 eval of that
float32 victim.  Every checkpoint holds float32 parameters and statistics.

The subprocess reads each checkpoint as it is written and deletes it once
no later run loads it, so at most four of the ~160 MB checkpoints are on
disk at once.  The session's xdist workers share one run of it (a file
lock in the session's base temporary directory), however they split this
file's tests.
"""

import json
import os

import pytest
from filelock import FileLock

from test_torch_cli import _run
from test_torch_variant_cli import RUNS as VARIANT_RUNS

VARIANTS = ("wanet", "inputaware", "imperceptible", "multilabel")
BF16 = ["--compute_dtype", "bfloat16"]
F32 = ["--compute_dtype", "float32"]
# (entry point, saving prefix or None, flags) in the order they run
RUNS = (
    ("train_clean_classifier", "cl", BF16),
    ("train_generator", "atk", BF16 + ["--load_checkpoint_clean", "cl"]),
    ("train_victim", "vic", BF16 + ["--load_checkpoint", "atk_clean"]),
    ("eval", None, BF16 + ["--load_checkpoint_clean", "vic_clean", "--load_checkpoint", "atk_clean"]),
    *((entry, VARIANT_RUNS[entry][0], BF16 + VARIANT_RUNS[entry][1]) for variant in VARIANTS
      for entry in (f"train_generator_{variant}", f"train_victim_{variant}")),  # each victim after its generator
    ("train_clean_classifier", "cl32", F32),
    ("train_generator", "atk_x", BF16 + ["--load_checkpoint_clean", "cl32"]),
    ("train_victim", "vic32", F32 + ["--load_checkpoint", "atk_clean"]),
    ("eval", None, BF16 + ["--load_checkpoint_clean", "vic32_clean", "--load_checkpoint", "atk_clean"]),
)
SAVED = [(entry, prefix) for entry, prefix, _ in RUNS if prefix]


def _checkpoint_dir(entry, prefix):
    return prefix if entry == "train_clean_classifier" else f"{prefix}_clean"


def _last_reads():
    """Each checkpoint directory -> the index of the last run that writes or
    loads it."""
    last = {}
    for i, (entry, prefix, flags) in enumerate(RUNS):
        if prefix:
            last[_checkpoint_dir(entry, prefix)] = i
        for j, flag in enumerate(flags):
            if flag in ("--load_checkpoint", "--load_checkpoint_clean"):
                last[flags[j + 1]] = i
    return last


# Runs in the subprocess after each entry point: what the tests read of the
# checkpoint it wrote, then the checkpoints no later run loads go.
_SUMMARY = """
def summary(name):
    payload = torch.load(f"{ck}/{name}/cifar10/cifar10_{name}.pt", weights_only=True)
    models = {k: sd for k, sd in payload.items() if k.startswith("net") or k == "clean_model"}
    return {
        "models": sorted(models),
        "not_float32_or_finite": [(key, k, str(t.dtype)) for key, sd in models.items() for k, t in sd.items()
                                  if t.is_floating_point() and not (t.dtype == torch.float32
                                                                    and bool(torch.isfinite(t).all()))],
        "steps": payload["schedulerC"]["step"],
        "F_detector_loaded": payload.get("F_detector_loaded", True),
    }
"""


def _run_every_entry_point(ck):
    common = ["--device", "cpu", "--synthetic_data", "--synthetic_size", "20", "--bs", "8", "--n_iters", "1",
              "--checkpoints", str(ck)]
    code = (
        "import importlib, json, shutil, sys\n"
        "import torch\n"
        "from combat_tpu_torch.cli import _alternated, _victim, train_clean_classifier\n"
        "_alternated.best_gate_attack = _victim.best_gate_clean = train_clean_classifier.best_gate_clean = "
        "lambda *a: True\n"
        "a = sys.argv[1:]\n"
        f"ck = {str(ck)!r}\n" + _SUMMARY
    )
    last = _last_reads()
    for i, (entry, prefix, flags) in enumerate(RUNS):
        flags = flags + (["--saving_prefix", prefix] if prefix else [])
        code += (f"print('RESULT {entry}', "
                 f"importlib.import_module('combat_tpu_torch.cli.{entry}').main(a + {flags!r}))\n")
        if prefix:
            code += f"print('SUMMARY', json.dumps([{prefix!r}, summary({_checkpoint_dir(entry, prefix)!r})]))\n"
        for name in sorted(d for d, j in last.items() if j == i):
            code += f"shutil.rmtree(f'{{ck}}/{name}')\n"
    proc = _run(code, *common, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert not list(ck.rglob("*.pt"))  # every checkpoint read and gone
    summary = dict(json.loads(line.split(" ", 1)[1]) for line in proc.stdout.splitlines()
                   if line.startswith("SUMMARY "))
    return summary, proc.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each saving prefix's checkpoint summary, the subprocess's output),
    made once a session."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _run_every_entry_point(tmp_path_factory.mktemp("bf16_cli"))
    shared = tmp_path_factory.getbasetemp().parent / "bf16_cli.json"  # the session's, shared by its workers
    with FileLock(f"{shared}.lock"):
        if not shared.is_file():
            shared.write_text(json.dumps(_run_every_entry_point(tmp_path_factory.mktemp("bf16_cli"))))
        summary, out = json.loads(shared.read_text())
    return summary, out


@pytest.mark.parametrize("entry,prefix", SAVED, ids=[p for _, p in SAVED])
def test_bf16_cli_checkpoint_holds_float32_models(runs, entry, prefix):
    summary = runs[0][prefix]
    assert "netC" in summary["models"]
    assert summary["not_float32_or_finite"] == []
    assert summary["steps"] == 3  # 8 + 8 + a tail of 4
    assert summary["F_detector_loaded"] is True


def test_bf16_cli_runs_every_entry_point_in_its_dtype(runs):
    """Each run prints its compute dtype with the device; the evals' Clean
    Acc, Bd BA and Bd ASR are percentages."""
    _, out = runs
    dtypes = [line.split("compute dtype: ")[1] for line in out.splitlines() if "compute dtype: " in line]
    assert dtypes == ["torch.bfloat16" if flags[1] == "bfloat16" else "torch.float32" for _, _, flags in RUNS]
    evals = [line for line in out.splitlines() if line.startswith("RESULT eval")]
    assert len(evals) == 2
    for line in evals:
        values = [float(v) for v in line.split("(")[1].rstrip(")").split(",")]
        assert len(values) == 3 and all(0.0 <= v <= 100.0 for v in values), line
