"""Train the DCT-domain frequency detector on synthetic corruptions (the port
of ``combat_tpu/defenses/frequency_train.py``).

Reference ``defenses/frequency_based/train.py:275-344``: the dataset's
geometry, Adadelta (lr 0.05, weight decay 1e-4) for the ``original``
detectors and Adam (lr 0.02, weight decay 1e-4) for a classifier backbone
(``get_model:146-175``), and the best-accuracy checkpoint {netC,
optimizerC, best_acc, epoch_current} at
``<F_checkpoints>/<dataset>/<F_model>/<dataset>_<F_model>_detector.pt``
(``:310-311``), the path from which the port's generator stages load their
detector (``cli/common.py::detector_path``).  A fresh run deletes that
folder first, as the JAX package does: give ``--F_checkpoints`` a folder of
its own unless the detector there is to be replaced.

A detector trained on ``--synthetic_data`` is a smoke test of this tool,
not a detector of anything.

Run (on the card unless --device cpu):
  python -m combat_tpu_torch.defenses.frequency_train --synthetic_data \
      --synthetic_size 1024 --n_iters 2 --F_model original_dropout --F_checkpoints ./temps/F
"""

from __future__ import annotations

import os
from typing import Iterable

import torch

from ..checkpoint import load_checkpoint, save_checkpoint
from ..cli.common import defense_device, detector_path, device_dataset, setup_run_dirs
from ..config import Config, from_args
from ..models import get_frequency_detector
from ..train import (
    DETECTOR_EVAL_STREAM,
    TRAIN_STREAM,
    epoch_generator,
    eval_epoch,
    metrics_to_host,
    train_epoch_classifier,
)
from ..utils import MetricsLogger, NullLogger, Timer
from .frequency import make_detector_eval_step, make_detector_train_step

ADADELTA_DETECTORS = ("original", "original_holdout", "original_dropout", "original_dropout_ensemble")


def detector_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """optax's ``add_decayed_weights(1e-4)`` before ``adadelta`` / ``adam``
    adds 1e-4 x the parameter to its gradient: torch's ``weight_decay``
    (L2 in the gradient, not AdamW)."""
    if cfg.F_model in ADADELTA_DETECTORS:
        return torch.optim.Adadelta(params, lr=0.05, rho=0.9, eps=1e-6, weight_decay=1e-4)
    return torch.optim.Adam(params, lr=0.02, weight_decay=1e-4)


def _to01(x: torch.Tensor) -> torch.Tensor:
    """A [-1, 1] batch as the frequency loader's [0, 1] image
    (reference ``train.py:301-302``)."""
    return (x + 1.0) / 2.0


def run(cfg: Config) -> float:
    device, writes = defense_device(cfg)
    imgs, labs = device_dataset(cfg, device, True)
    timgs, tlabs = device_dataset(cfg, device, False)

    torch.manual_seed(cfg.seed)
    C = get_frequency_detector(cfg).to(device)
    optimizer = detector_optimizer(cfg, C.parameters())
    path = detector_path(cfg)
    ckpt_folder = os.path.dirname(path)

    best_acc, epoch_current = 0.0, 0
    if cfg.continue_training:
        if not os.path.exists(path):
            raise SystemExit("Pretrained model doesnt exist")
        print("Continue training!!")
        # the detector's weights and statistics, as the JAX package restores
        # them; its optimizer starts anew there too
        payload = load_checkpoint(path, map_location=device)
        C.load_state_dict(payload["netC"])
        best_acc = float(payload["best_acc"])
        epoch_current = int(payload["epoch_current"]) + 1
        fresh = False
    else:
        print("Train from scratch!!!")
        fresh = True
    logger = NullLogger()
    if writes:
        logger = MetricsLogger(setup_run_dirs(cfg, ckpt_folder, fresh=fresh), run_name="detector")
    train_step = make_detector_train_step(C)
    eval_step = make_detector_eval_step(C)
    for epoch in range(epoch_current, cfg.n_iters):
        with Timer() as t:
            m = metrics_to_host(train_epoch_classifier(
                lambda opt, b, gen: train_step(opt, (_to01(b[0]), b[1]), gen), optimizer, imgs, labs,
                epoch_generator(cfg.seed, TRAIN_STREAM, epoch, device), cfg.bs,
            ))
        acc_train = m["correct"] * 100 / m["sample"]
        em = metrics_to_host(eval_epoch(
            lambda b, **kw: eval_step((_to01(b[0]), *b[1:]), **kw), (), timgs, tlabs, cfg.bs,
            generator=epoch_generator(cfg.seed, DETECTOR_EVAL_STREAM, epoch, device),
        ))
        acc = em["correct"] * 100 / em["sample"]
        print(f"Epoch {epoch + 1}: CE Loss: {m['loss_ce'] / m['sample']:.4f} | Train Acc: {acc_train:.4f} | "
              f"Acc: {acc:.4f} - Best: {best_acc:.4f} | {m['sample'] / t.seconds:.0f} img/s")
        logger.log(epoch, {"loss_ce": m["loss_ce"] / m["sample"], "train_acc": acc_train})
        logger.log(epoch, {"acc": acc}, group="test")
        if acc > best_acc:
            print(" Saving...")
            best_acc = acc
            if writes:
                save_checkpoint(path, {
                    "netC": C.state_dict(),
                    "optimizerC": optimizer.state_dict(),
                    "best_acc": best_acc,
                    "epoch_current": epoch,
                })
    logger.close()
    return best_acc


def main(argv=None):
    return run(from_args(argv))


if __name__ == "__main__":
    main()
