"""Victim training with a frozen trigger generator (the port of
``combat_tpu/cli/_victim.py``): one run loop for the base (and
imperceptible), WaNet and input-aware victims; the multilabel victim
continues alternated training instead (``_alternated.py``).

The run poisons a fixed subset of the training split (``poison_flags``),
loads G from the generator run's checkpoint and trains C from scratch on the
mixed batches, then evaluates clean accuracy and the attack's success rate
every epoch.  The best-clean-acc gate picks the checkpoint saved, with the
reference's keys {netC, schedulerC, optimizerC, netG, best_clean_acc,
best_bd_acc, epoch_current}.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..checkpoint import best_gate_clean, ckpt_path, load_checkpoint, save_checkpoint
from ..config import Config
from ..data import poison_candidates, poison_flags
from ..models import get_classifier, get_generator
from ..train import (
    TrainState,
    eval_epoch,
    freeze,
    make_victim_eval_step,
    make_victim_train_step,
    metrics_to_host,
    multistep_lr,
    multistep_lr_resume,
    train_epoch_classifier,
)
from ..utils import MetricsLogger, Timer
from .common import device_dataset, fmt_pct, setup_device, setup_run_dirs, steps_per_epoch, warn_on_cadence_change


@dataclass(frozen=True)
class VictimSpec:
    name: str
    generator_kind: str = "unet"
    make_train_step: Callable = make_victim_train_step
    make_eval_step: Callable = make_victim_eval_step
    eval_pair: bool = False  # a second test stream for the cross accuracy
    track_cross: bool = False
    extra_ckpt: Optional[Callable[[Config], Dict]] = None  # more checkpoint keys


def run_victim(cfg: Config, spec: VictimSpec):
    device = setup_device(cfg)
    imgs, labs = device_dataset(cfg, device, True)
    timgs, tlabs = device_dataset(cfg, device, False)
    spe = steps_per_epoch(imgs.shape[0], cfg.bs)

    labels_np = labs.cpu().numpy()
    flags = poison_flags(labels_np, cfg.pc, cfg.target_label, cfg.attack_mode, seed=cfg.seed)
    n_candidates = poison_candidates(labels_np, cfg.target_label, cfg.attack_mode).shape[0]
    print(f"Poison {int(flags.sum())} images ({cfg.pc * n_candidates})")
    poisoned = torch.from_numpy(flags).to(device)

    torch.manual_seed(cfg.seed)
    C = get_classifier(cfg).to(device)
    G = get_generator(cfg, spec.generator_kind).to(device)
    stateC = TrainState(C, multistep_lr(cfg.lr_C, cfg.schedulerC_milestones, cfg.schedulerC_lambda, spe))
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    # frozen generator of the attack run (reference train_victim.py:270-280)
    if not cfg.load_checkpoint:
        raise SystemExit("--load_checkpoint is required (generator run name, e.g. <prefix>_clean)")
    g_path = ckpt_path(cfg.checkpoints, cfg.load_checkpoint, cfg.dataset)
    if not os.path.exists(g_path):
        raise SystemExit(f"Error: {g_path} not found")
    G.load_state_dict(load_checkpoint(g_path, map_location=device)["netG"])
    freeze(G)

    mode = cfg.saving_prefix or spec.name
    path = ckpt_path(cfg.checkpoints, f"{mode}_clean", cfg.dataset)
    ckpt_folder = os.path.dirname(path)
    best = {"best_clean_acc": 0.0, "best_bd_acc": 0.0}
    if spec.track_cross:
        best["best_cross_acc"] = 0.0
    epoch_current = 0
    extra = spec.extra_ckpt(cfg) if spec.extra_ckpt else {}

    def payload_of(epoch):
        return {
            "netC": C.state_dict(),
            "schedulerC": {"step": stateC.step},
            "optimizerC": stateC.optimizer.state_dict(),
            "netG": G.state_dict(),
            **best,
            **extra,
            "scheduler_steps_per_epoch": spe,
            "epoch_current": epoch,
        }

    if cfg.continue_training:
        if not os.path.exists(path):
            raise SystemExit("Pretrained model doesnt exist")
        print("Continue training!!")
        payload = load_checkpoint(path, map_location=device)
        warn_on_cadence_change(payload, spe)
        epoch_current = int(payload["epoch_current"]) + 1
        C.load_state_dict(payload["netC"])
        stateC.optimizer.load_state_dict(payload["optimizerC"])
        stateC.step = int(payload["schedulerC"]["step"])
        stateC.schedule = multistep_lr_resume(
            cfg.lr_C, cfg.schedulerC_milestones, cfg.schedulerC_lambda, spe, epoch_current, stateC.step
        )
        best = {k: float(payload[k]) for k in best}
        log_dir = setup_run_dirs(cfg, ckpt_folder, fresh=False)
    else:
        print("Train from scratch!!!")
        log_dir = setup_run_dirs(cfg, ckpt_folder, fresh=True)

    logger = MetricsLogger(log_dir)
    train_step = spec.make_train_step(cfg, C, G)
    eval_step = spec.make_eval_step(cfg, C, G)
    for epoch in range(epoch_current, cfg.n_iters):
        with Timer() as t:
            m = metrics_to_host(
                train_epoch_classifier(train_step, stateC, imgs, labs, generator, cfg.bs, poisoned=poisoned)
            )
        n = m["sample"]
        ips = n / t.seconds
        em = metrics_to_host(
            eval_epoch(eval_step, (), timgs, tlabs, cfg.bs, with_pair=spec.eval_pair, generator=generator)
        )
        acc_clean = em["clean_correct"] * 100 / em["clean_sample"]
        acc_bd = em["bd_correct"] * 100 / max(em["bd_sample"], 1.0)
        line = (
            f"Epoch {epoch + 1}: CE Loss: {fmt_pct(m['loss_ce'] / n)} | "
            f"Train Acc: {fmt_pct(m['clean_correct'] * 100 / n)} | "
            f"Clean Acc: {fmt_pct(acc_clean)} - Best: {fmt_pct(best['best_clean_acc'])} | "
            f"Bd Acc: {fmt_pct(acc_bd)} - Best: {fmt_pct(best['best_bd_acc'])}"
        )
        scalars = {"Clean": acc_clean, "Bd": acc_bd}
        if spec.track_cross:
            cross = em["cross_correct"] * 100 / max(em["bd_sample"], 1.0)
            line += f" | Cross Acc: {fmt_pct(cross)}"
            scalars["Cross"] = cross
        print(line + f" | {ips:.0f} img/s")
        logger.log(epoch, {"loss_ce": m["loss_ce"] / n, "Clean": m["clean_correct"] * 100 / n, "images_per_sec": ips})
        logger.log(epoch, scalars, group="test")
        if best_gate_clean(acc_clean, best["best_clean_acc"]):
            print(" Saving...")
            best["best_clean_acc"], best["best_bd_acc"] = acc_clean, acc_bd
            if spec.track_cross:
                best["best_cross_acc"] = cross
            save_checkpoint(path, payload_of(epoch))
    logger.close()
    return best
