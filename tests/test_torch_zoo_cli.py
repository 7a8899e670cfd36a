"""The entry points with the rest of the model registry, on the CPU with JAX
blocked (``tests/test_torch_cli.py``'s runner): ``--model vgg11`` and
``--model simplevitsmall8`` through clean -> generator -> victim -> eval,
``--F_model original_dropout_ensemble`` through the generator and eval, and
gtsrb (43 classes, 32 px) through the four stages.  Tiny: 16 synthetic
images at bs 8 (two steps a stage).  The save gates are open, as in
``tests/test_torch_celeba.py``: two steps can score 0 on the test rows.
"""

import shutil

import pytest
import torch

from test_torch_cli import _run

# The four stages in one process; extra flags for every stage come after the
# common ones on the command line, and ``F`` names the generator's --F_model.
MAIN_PATH = (
    "import sys\n"
    "from combat_tpu_torch.cli import train_clean_classifier, train_generator, train_victim\n"
    "from combat_tpu_torch.cli import eval as final_eval\n"
    "from combat_tpu_torch.cli import _alternated, _victim\n"
    "_alternated.best_gate_attack = _victim.best_gate_clean = lambda *a: True\n"
    "train_clean_classifier.best_gate_clean = lambda *a: True\n"
    "a = sys.argv[1:]\n"
    "train_clean_classifier.main(a + ['--saving_prefix', 'cl'])\n"
    "train_generator.main(a + ['--saving_prefix', 'atk', '--load_checkpoint_clean', 'cl'])\n"
    "train_victim.main(a + ['--saving_prefix', 'vic', '--load_checkpoint', 'atk_clean'])\n"
    "print('EVAL', list(final_eval.main(a + ['--load_checkpoint_clean', 'vic_clean', "
    "'--load_checkpoint', 'atk_clean'])))\n"
)


def _common(ck, *flags):
    return ["--device", "cpu", "--synthetic_data", "--synthetic_size", "16", "--bs", "8", "--n_iters", "1",
            "--checkpoints", ck, *flags]


def _load(tmp_path, run, dataset="cifar10"):
    return torch.load(tmp_path / f"ck/{run}/{dataset}/{dataset}_{run}.pt", weights_only=True)


def _eval_percentages(stdout):
    values = [float(v) for v in stdout.split("EVAL ")[1].strip("[]\n").split(",")]
    assert len(values) == 3 and all(0.0 <= v <= 100.0 for v in values)


@pytest.mark.parametrize("model,head", [("vgg11", "classifier.weight"), ("simplevitsmall8", "head.weight")])
def test_named_model_main_path_cli_without_jax(model, head, tmp_path):
    """Every stage builds ``--model`` (the clean model, the surrogate and
    the victim) and writes its checkpoint, finite, with two steps taken."""
    ck = str(tmp_path / "ck")
    proc = _run(MAIN_PATH, *_common(ck, "--model", model))
    assert proc.returncode == 0, proc.stderr[-3000:]
    atk, vic = _load(tmp_path, "atk_clean"), _load(tmp_path, "vic_clean")
    assert atk["schedulerC"]["step"] == atk["schedulerG"]["step"] == vic["schedulerC"]["step"] == 2
    for sd in (atk["netC"], atk["clean_model"], vic["netC"]):
        assert tuple(sd[head].shape) == ((10, 512) if model == "vgg11" else (10, 384))
        assert all(torch.isfinite(v).all() for v in sd.values() if v.is_floating_point())
    _eval_percentages(proc.stdout)
    shutil.rmtree(ck)


def test_gtsrb_main_path_cli_without_jax(tmp_path):
    """gtsrb: 43 classes at 32 px on its default PreActResNet18, with no
    detector in the repo (F Acc from a random detector, recorded)."""
    ck = str(tmp_path / "ck")
    proc = _run(MAIN_PATH, *_common(ck, "--dataset", "gtsrb"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    atk = _load(tmp_path, "atk_clean", "gtsrb")
    assert tuple(atk["netC"]["linear.weight"].shape) == (43, 512)
    assert atk["F_detector_loaded"] is False and atk["schedulerG"]["step"] == 2
    assert _load(tmp_path, "vic_clean", "gtsrb")["schedulerC"]["step"] == 2
    _eval_percentages(proc.stdout)
    shutil.rmtree(ck)


def test_dropout_ensemble_detector_cli_without_jax(tmp_path):
    """``--F_model original_dropout_ensemble`` through the generator and
    eval: the detector's ``.pt`` is not in the repo, so its F Acc comes from
    a random detector and the checkpoint records ``F_detector_loaded``
    false, as in the JAX package; the run looks for the detector's own path
    and loads no other."""
    ck = str(tmp_path / "ck")
    code = (
        "import sys\n"
        "from combat_tpu_torch.cli import train_clean_classifier, train_generator\n"
        "from combat_tpu_torch.cli import eval as final_eval\n"
        "from combat_tpu_torch.cli import _alternated\n"
        "_alternated.best_gate_attack = train_clean_classifier.best_gate_clean = lambda *a: True\n"
        "a = sys.argv[1:]\n"
        "train_clean_classifier.main(a + ['--saving_prefix', 'cl'])\n"
        "a += ['--F_model', 'original_dropout_ensemble']\n"
        "train_generator.main(a + ['--saving_prefix', 'atk', '--load_checkpoint_clean', 'cl'])\n"
        "print('EVAL', list(final_eval.main(a + ['--load_checkpoint_clean', 'atk_clean', "
        "'--load_checkpoint', 'atk_clean'])))\n"
    )
    proc = _run(code, *_common(ck))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "original_dropout_ensemble/cifar10_original_dropout_ensemble_detector.pt" in proc.stdout
    assert "frequency-detector checkpoint not found" in proc.stdout
    atk = _load(tmp_path, "atk_clean")
    assert atk["F_detector_loaded"] is False and atk["schedulerG"]["step"] == 2
    _eval_percentages(proc.stdout)
    shutil.rmtree(ck)
