"""Train the clean reference classifier (the port of
``combat_tpu/cli/train_clean_classifier.py``).

Per-epoch augmented CE training, clean-accuracy eval, the best-clean-acc
checkpoint gate with keys {netC, schedulerC, optimizerC, best_clean_acc,
epoch_current}, the path scheme
``<checkpoints>/<prefix>/<dataset>/<dataset>_<prefix>.pt`` and
``--continue_training`` resume.

Run (synthetic data; on the card unless --device cpu):
  python -m combat_tpu_torch.cli.train_clean_classifier --dataset cifar10 \
      --synthetic_data --synthetic_size 1024 --n_iters 2 --saving_prefix cleanmodel
"""

from __future__ import annotations

import os

import torch

from ..checkpoint import best_gate_clean, ckpt_path, load_checkpoint
from ..config import Config, from_args
from ..models import get_classifier
from ..train import (
    TRAIN_STREAM,
    TrainState,
    epoch_generator,
    eval_epoch,
    make_clean_eval_step,
    make_clean_train_step,
    metrics_to_host,
    multistep_lr,
    multistep_lr_resume,
    train_epoch_classifier,
)
from ..train.mesh import World, replicate
from ..utils import Timer, profile_epoch
from .common import (
    device_dataset,
    fmt_pct,
    run_dirs,
    run_logger,
    run_on_world,
    save_on_main,
    steps_per_epoch,
    warn_on_cadence_change,
)


def run(cfg: Config) -> float:
    """The best clean accuracy; data-parallel over ``--n_devices`` /
    ``--multihost`` ranks (``cli/common.py::run_on_world``), rank 0 alone
    writing."""
    return run_on_world(_run, cfg)


def _run(cfg: Config, world: World) -> float:
    device = world.device
    imgs, labs = device_dataset(cfg, device, True)
    timgs, tlabs = device_dataset(cfg, device, False)
    spe = steps_per_epoch(imgs.shape[0], cfg.bs)

    torch.manual_seed(cfg.seed)
    C = get_classifier(cfg).to(device)
    stateC = TrainState(C, multistep_lr(cfg.lr_C, cfg.schedulerC_milestones, cfg.schedulerC_lambda, spe), world)

    mode = cfg.saving_prefix or "clean"
    path = ckpt_path(cfg.checkpoints, mode, cfg.dataset)
    ckpt_folder = os.path.dirname(path)

    best_clean_acc, epoch_current = 0.0, 0
    if cfg.continue_training:
        if not os.path.exists(path):
            raise SystemExit("Pretrained model doesnt exist")
        print("Continue training!!")
        payload = load_checkpoint(path, map_location=device)
        warn_on_cadence_change(payload, spe)
        C.load_state_dict(payload["netC"])
        stateC.optimizer.load_state_dict(payload["optimizerC"])
        stateC.step = int(payload["schedulerC"]["step"])
        stateC.schedule = multistep_lr_resume(
            cfg.lr_C, cfg.schedulerC_milestones, cfg.schedulerC_lambda, spe,
            epochs_done=int(payload["epoch_current"]) + 1, resume_step=stateC.step,
        )
        best_clean_acc = float(payload["best_clean_acc"])
        epoch_current = int(payload["epoch_current"]) + 1
        log_dir = run_dirs(cfg, world, ckpt_folder, fresh=False)
    else:
        print("Train from scratch!!!")
        log_dir = run_dirs(cfg, world, ckpt_folder, fresh=True)
    replicate(C, world)  # built and loaded alike on every rank; rank 0's, exactly

    logger = run_logger(world, log_dir)
    train_step = make_clean_train_step(cfg, C)
    eval_step = make_clean_eval_step(C)
    for epoch in range(epoch_current, cfg.n_iters):
        with Timer() as t, profile_epoch(cfg.profile_dir if world.is_main else "", epoch, epoch_current, device):
            m = metrics_to_host(train_epoch_classifier(
                train_step, stateC, imgs, labs, epoch_generator(cfg.seed, TRAIN_STREAM, epoch, device), cfg.bs,
                world=world))
        train_acc = m["clean_correct"] * 100.0 / m["sample"]
        ips = m["sample"] / t.seconds  # the global batch's rows
        em = metrics_to_host(eval_epoch(eval_step, (), timgs, tlabs, cfg.bs, world=world))
        acc_clean = em["clean_correct"] * 100.0 / em["clean_sample"]
        print(
            f"Epoch {epoch + 1}: CE Loss: {fmt_pct(m['loss_ce'] / m['sample'])} | "
            f"Train Acc: {fmt_pct(train_acc)} | Clean Acc: {fmt_pct(acc_clean)} - Best: {fmt_pct(best_clean_acc)} | "
            f"{ips:.0f} img/s"
        )
        logger.log(epoch, {"loss_ce": m["loss_ce"] / m["sample"], "train_acc": train_acc, "images_per_sec": ips})
        logger.log(epoch, {"clean_acc": acc_clean}, group="test")
        if best_gate_clean(acc_clean, best_clean_acc):
            print(" Saving...")
            best_clean_acc = acc_clean
            save_on_main(
                world,
                path,
                lambda: {
                    "netC": C.state_dict(),
                    "optimizerC": stateC.optimizer.state_dict(),
                    "schedulerC": {"step": stateC.step},
                    "best_clean_acc": best_clean_acc,
                    "scheduler_steps_per_epoch": spe,
                    "epoch_current": epoch,
                },
            )
    logger.close()
    return best_clean_acc


def main(argv=None):
    run(from_args(argv))


if __name__ == "__main__":
    main()
