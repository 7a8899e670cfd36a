"""The entry points with the extended zoo, on the CPU with JAX blocked
(``tests/test_torch_cli.py``'s runner): ``--model lenet`` and ``--model
senet18`` (in bfloat16: its float32 squeeze-excitation reads a bfloat16
mean) through clean -> generator -> victim -> eval; ``frequency_train
--F_model efficientnetb0`` (its dropout live in train mode, masks drawn by
the detector step), then a generator that loads that detector and its eval.
Tiny: 16 synthetic images at bs 8 (two steps a stage), the save gates open
as in ``tests/test_torch_zoo_cli.py``.  And the place where both packages
stop: ``--model efficientnetb0``'s C-step, whose dropout needs an rng the
JAX steps do not pass.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cli import _run
from test_torch_zoo_cli import MAIN_PATH, _common, _eval_percentages, _load
from test_torch_zoo_extra_models import EFFICIENTNET


@pytest.mark.parametrize("model,flags,head", [
    ("lenet", (), ("fc3.weight", (10, 84))),
    ("senet18", ("--compute_dtype", "bfloat16"), ("linear.weight", (10, 512))),
])
def test_zoo_extra_main_path_cli_without_jax(model, flags, head, tmp_path):
    """Every stage builds ``--model`` (the clean model, the surrogate and
    the victim) and writes its checkpoint, finite and float32, with two
    steps taken."""
    ck = str(tmp_path / "ck")
    proc = _run(MAIN_PATH, *_common(ck, "--model", model, *flags))
    assert proc.returncode == 0, proc.stderr[-3000:]
    atk, vic = _load(tmp_path, "atk_clean"), _load(tmp_path, "vic_clean")
    assert atk["schedulerC"]["step"] == atk["schedulerG"]["step"] == vic["schedulerC"]["step"] == 2
    for sd in (atk["netC"], atk["clean_model"], vic["netC"]):
        assert tuple(sd[head[0]].shape) == head[1]
        assert all(torch.isfinite(v).all() and v.dtype == torch.float32 for v in sd.values() if v.is_floating_point())
    _eval_percentages(proc.stdout)
    shutil.rmtree(ck)


def test_efficientnet_detector_trains_and_loads_without_jax(tmp_path):
    """``frequency_train --F_model efficientnetb0`` trains (Adam, its
    broadcast dropout masks drawn a step) and writes the detector; the
    generator stage loads it (``F_detector_loaded`` true, its dropout off
    in eval mode) and eval runs."""
    ck, F = str(tmp_path / "ck"), str(tmp_path / "F")
    code = (
        "import sys\n"
        "from combat_tpu_torch.cli import train_clean_classifier, train_generator\n"
        "from combat_tpu_torch.cli import eval as final_eval\n"
        "from combat_tpu_torch.cli import _alternated\n"
        "from combat_tpu_torch.defenses import frequency_train\n"
        "_alternated.best_gate_attack = train_clean_classifier.best_gate_clean = lambda *a: True\n"
        "a, F = sys.argv[1:-1], sys.argv[-1]\n"
        "train_clean_classifier.main(a + ['--saving_prefix', 'cl'])\n"
        "a += ['--F_model', 'efficientnetb0', '--F_checkpoints', F]\n"
        "frequency_train.main(a)\n"
        "train_generator.main(a + ['--saving_prefix', 'atk', '--load_checkpoint_clean', 'cl'])\n"
        "print('EVAL', list(final_eval.main(a + ['--load_checkpoint_clean', 'atk_clean', "
        "'--load_checkpoint', 'atk_clean'])))\n"
    )
    proc = _run(code, *_common(ck), F)
    assert proc.returncode == 0, proc.stderr[-3000:]
    det = torch.load(tmp_path / "F/cifar10/efficientnetb0/cifar10_efficientnetb0_detector.pt", weights_only=True)
    assert tuple(det["netC"]["linear.weight"].shape) == (2, 320)
    assert all(torch.isfinite(v).all() for v in det["netC"].values() if v.is_floating_point())
    atk = _load(tmp_path, "atk_clean")
    assert atk["F_detector_loaded"] is True and atk["schedulerG"]["step"] == 2
    _eval_percentages(proc.stdout)
    shutil.rmtree(ck)


def test_efficientnetb0_c_step_stops_in_both_packages(tmp_path):
    """``--model efficientnetb0``: the JAX C-step applies it with train=True
    and no ``dropout`` rng (``InvalidRngError``); every training step of the
    port refuses it with a ``NotImplementedError`` naming that rng, and so
    does the clean classifier's entry point."""
    import flax

    from combat_tpu.models.zoo_extra import EfficientNetB0 as JaxEfficientNet
    from combat_tpu.train import init_train_state, multistep_lr, sgd_torch
    from combat_tpu.train.steps import make_clean_train_step as jax_make

    from combat_tpu_torch.cli import train_clean_classifier
    from combat_tpu_torch.models import UnetGenerator, get_classifier
    from combat_tpu_torch.train import make_alternated_train_step, make_clean_train_step, make_victim_train_step
    from test_torch_steps import _configs

    jcfg, cfg = _configs(model="efficientnetb0")
    x, y = np.zeros((2, 32, 32, 3), np.float32), np.zeros((2,), np.int32)
    C = JaxEfficientNet(10, cfg=EFFICIENTNET)  # the registry's table stops the same way, in a longer compile
    state = init_train_state(C, jax.random.key(0), jnp.asarray(x[:1]), sgd_torch(multistep_lr(0.01, (100,), 0.1, 1)))
    with pytest.raises(flax.errors.InvalidRngError, match="dropout"):
        jax_make(jcfg, C)(state, (jnp.asarray(x), jnp.asarray(y)), jax.random.key(1))

    model, G = get_classifier(cfg), UnetGenerator()
    for make in (lambda: make_clean_train_step(cfg, model), lambda: make_alternated_train_step(cfg, model, G),
                 lambda: make_victim_train_step(cfg, model, G)):
        with pytest.raises(NotImplementedError, match="EfficientNetB0 has dropout.*no 'dropout' rng"):
            make()
    with pytest.raises(NotImplementedError, match="no 'dropout' rng"):
        train_clean_classifier.main(["--device", "cpu", "--synthetic_data", "--synthetic_size", "16", "--bs", "8",
                                     "--model", "efficientnetb0", "--checkpoints", str(tmp_path / "ck")])
