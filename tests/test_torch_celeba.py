"""celeba in the port: its committed frequency detector, and the main path's
four entry points at 64 px with ResNet18.

``defenses/frequency_based/checkpoints/celeba/original/`` holds the JAX
package's orbax checkpoint of celeba's detector and, beside it, the ``.pt``
that ``scripts/export_torch_detector.py --src ... --out ...`` converts from
it.  The ``.pt`` holds the converted orbax numbers exactly, and the port's
``FrequencyModel`` with it gives the JAX detector's logits on 64 px inputs
within 1e-4 (float32 convolutions in another summation order on DCT
features of magnitude up to ~1e4), as tests/test_torch_detector.py holds
cifar10's.  The CLI test drives clean -> generator -> victim -> eval with
``--dataset celeba`` on the CPU with JAX blocked, and the generator stage
loads that detector.
"""

import os
import runpy
import shutil

import jax
import numpy as np
import pytest
import torch

from _torch_helpers import nchw, to_numpy_tree
from test_torch_cli import _run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DETECTOR_DIR = os.path.join(REPO, "defenses/frequency_based/checkpoints/celeba/original")
ORBAX = os.path.join(DETECTOR_DIR, "celeba_original_detector.ckpt")
COMMITTED = os.path.join(DETECTOR_DIR, "celeba_original_detector.pt")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def test_committed_celeba_detector_is_the_converted_orbax_checkpoint(tmp_path):
    """The export script, run on the orbax checkpoint, writes tensors equal
    to the committed ``.pt``'s, which hold every number of the checkpoint:
    six convs of 32/32/64/64/128/128 channels and a 8192 x 2 head (128 x 8
    x 8, the 64 px geometry)."""
    from combat_tpu.checkpoint import load_checkpoint as jax_load

    out = tmp_path / "detector.pt"
    runpy.run_path(os.path.join(REPO, "scripts/export_torch_detector.py"), run_name="export")["main"](
        ["--src", ORBAX, "--out", str(out)]
    )
    got = torch.load(out, weights_only=True)["netC"]
    ref = torch.load(COMMITTED, weights_only=True)["netC"]
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert [ref[f"conv{i}.weight"].shape[0] for i in range(6)] == [32, 32, 64, 64, 128, 128]
    assert tuple(ref["linear.weight"].shape) == (2, 128 * 8 * 8)
    n_orbax = sum(np.asarray(a).size for a in jax.tree.leaves(jax_load(ORBAX)["netC"]))
    assert sum(t.numel() for k, t in ref.items() if not k.endswith("num_batches_tracked")) == n_orbax


def test_committed_celeba_detector_matches_jax_detector():
    from combat_tpu.checkpoint import load_checkpoint as jax_load
    from combat_tpu.models.frequency import FrequencyModel as JaxFrequency
    from combat_tpu.ops.dct import detector_features as jax_features

    from combat_tpu_torch.checkpoint import load_checkpoint
    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_frequency_detector
    from combat_tpu_torch.ops.dct import detector_features

    payload = jax_load(ORBAX)
    assert float(payload["best_acc"]) > 98.0  # a trained detector (98.94 at epoch 42)
    x = np.random.default_rng(0).uniform(-1, 1, (8, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(JaxFrequency(num_classes=2).apply(to_numpy_tree(payload["netC"]), jax_features(x), train=False))

    netF = get_frequency_detector(apply_dataset_preset(Config(dataset="celeba", device="cpu")))
    netF.load_state_dict(load_checkpoint(COMMITTED)["netC"])
    netF.eval()
    with torch.no_grad():
        got = netF(detector_features(nchw(x))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert np.abs(ref).max() > 1e-2


def test_celeba_main_path_cli_on_cpu_without_jax(tmp_path):
    """clean -> generator -> victim -> eval with ``--dataset celeba`` (64 px,
    8 classes, ResNet18, UNet nf 64) at 16 synthetic images and bs 8, with
    JAX blocked: every stage writes its checkpoint, the generator's says it
    loaded the committed celeba detector, and eval prints three
    percentages."""
    ck = str(tmp_path / "ck")
    common = ["--device", "cpu", "--dataset", "celeba", "--synthetic_data", "--synthetic_size", "16", "--bs", "8",
              "--n_iters", "1", "--checkpoints", ck]
    code = (
        "import sys\n"
        "from combat_tpu_torch.cli import train_clean_classifier, train_generator, train_victim\n"
        "from combat_tpu_torch.cli import eval as final_eval\n"
        "from combat_tpu_torch.cli import _alternated, _victim\n"
        "_alternated.best_gate_attack = _victim.best_gate_clean = lambda *a: True\n"
        "a = sys.argv[1:]\n"
        "train_clean_classifier.best_gate_clean = lambda *a: True\n"
        "train_clean_classifier.main(a + ['--saving_prefix', 'cl'])\n"
        "train_generator.main(a + ['--saving_prefix', 'atk', '--load_checkpoint_clean', 'cl'])\n"
        "train_victim.main(a + ['--saving_prefix', 'vic', '--load_checkpoint', 'atk_clean'])\n"
        "print('EVAL', list(final_eval.main(a + ['--load_checkpoint_clean', 'vic_clean', "
        "'--load_checkpoint', 'atk_clean'])))\n"
    )
    proc = _run(code, *common)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "frequency-detector checkpoint not found" not in proc.stdout
    atk = torch.load(tmp_path / "ck/atk_clean/celeba/celeba_atk_clean.pt", weights_only=True)
    assert atk["F_detector_loaded"] is True
    assert atk["schedulerC"]["step"] == atk["schedulerG"]["step"] == 2  # 16 images at bs 8
    assert tuple(atk["netC"]["linear.weight"].shape) == (8, 512 * 2 * 2)  # ResNet18's head at 64 px
    assert "layer1.0.bn1.running_var" in atk["netC"] and "layer2.0.shortcut.1.weight" in atk["netC"]
    vic = torch.load(tmp_path / "ck/vic_clean/celeba/celeba_vic_clean.pt", weights_only=True)
    assert vic["schedulerC"]["step"] == 2
    assert all(torch.isfinite(v).all() for v in vic["netC"].values() if v.is_floating_point())
    returned = [float(v) for v in proc.stdout.split("EVAL ")[1].strip("[]\n").split(",")]
    assert len(returned) == 3 and all(0.0 <= v <= 100.0 for v in returned)
    shutil.rmtree(ck)  # ~0.4 GB of ResNet18 checkpoints; pytest keeps the last runs' tmp_path
