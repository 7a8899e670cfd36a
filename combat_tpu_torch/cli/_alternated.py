"""Alternated training of the trigger generator G and the surrogate
classifier C (the port of ``combat_tpu/cli/_alternated.py``): one run loop
for the base generator, the WaNet, input-aware, imperceptible and
multilabel generators, and the multilabel victim, which continues
alternated training from the generator run.  An :class:`AlternatedSpec`
names each entry point's steps and what sets it apart.

Every ``--image_every`` epochs (20 by default, from the first) the run logs
a tensorboard grid of the first 16 test rows above their triggered copies
(:func:`image_grid`), when tensorboard is importable.  The grid's trigger
takes the route the flags pick, K1 on the card by default, where the JAX
package's grid always runs its XLA chain: the same function.  Its blur
sigma comes from a generator of its own, so the run's draws are the same
with or without it.

Under data parallelism (``cli/common.py::run_on_world``) every rank builds
and loads the same models, which :func:`replicate` then makes rank 0's, and
trains on its shard of each global batch; the metrics each rank reads are
summed over the ranks, so every rank takes the same best-epoch decisions,
and rank 0 alone writes the checkpoint, the logs, the grid and the trace."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..attack.triggers import warp_trigger
from ..checkpoint import best_gate_attack, ckpt_path, load_checkpoint
from ..config import Config
from ..models import get_classifier, get_frequency_detector, get_generator
from ..ops.blur import draw_sigma
from ..train import (
    EVAL_STREAM,
    GRID_STREAM,
    TRAIN_STREAM,
    TrainState,
    epoch_generator,
    eval_epoch,
    freeze,
    make_alternated_train_step,
    make_attack_eval_step,
    metrics_to_host,
    multistep_lr,
    multistep_lr_resume,
    train_epoch_alternated,
    train_epoch_alternated_pair,
)
from ..train.loop import dequantize
from ..train.mesh import World, replicate
from ..train.steps import _trigger_fn
from ..utils import Timer, profile_epoch
from .common import (
    detector_path,
    device_dataset,
    fmt_pct,
    run_dirs,
    run_logger,
    run_on_world,
    save_on_main,
    steps_per_epoch,
    warn_on_cadence_change,
)

BASE_BEST_KEYS = (
    "best_clean_acc",
    "best_bd_acc",
    "best_F_acc",
    "best_clean_model_acc",
    "best_clean_model_bd_ba",
    "best_clean_model_bd_asr",
)


@dataclass(frozen=True)
class AlternatedSpec:
    name: str
    generator_kind: str = "unet"
    make_train_step: Callable = make_alternated_train_step
    make_eval_step: Callable = make_attack_eval_step
    pair: bool = False  # a second shuffled stream (input-aware)
    conditional: bool = False  # G takes (x, y) (multilabel)
    g_lr_from_c: bool = False  # G's lr is lr_C * 0.1 on C's milestones (input-aware)
    track_cross: bool = False  # the cross-accuracy metric (input-aware)
    load_g: bool = False  # G starts from --load_checkpoint (multilabel victim)
    extra_ckpt: Optional[Callable[[Config], Dict]] = None  # more checkpoint keys


def _g_schedule_args(cfg: Config, spec: AlternatedSpec):
    """G's (lr, milestones, gamma): lr_C * 0.1 on C's milestones for
    ``g_lr_from_c`` (reference ``train_generator_inputaware.py:120-127``)."""
    if spec.g_lr_from_c:
        return cfg.lr_C * 0.1, cfg.schedulerC_milestones, cfg.schedulerC_lambda
    return cfg.lr_G, cfg.schedulerG_milestones, cfg.schedulerG_lambda


@torch.no_grad()
def image_grid(cfg: Config, spec: AlternatedSpec, G: torch.nn.Module, images: torch.Tensor,
               sigma_draw: torch.Tensor) -> torch.Tensor:
    """The first 16 rows of ``images`` (dequantized) above their triggered
    copies, concatenated along H like the reference's ``cat([inputs,
    inputs_bd], dim=2)`` (``train_generator.py:310-315``): the WaNet warp of
    G's flow, else the additive trigger of ``G(x)`` (``G(x, target)`` for the
    class-conditional G) with the blur sigma ``sigma_draw``."""
    xb = dequantize(images[:16])
    if spec.generator_kind == "grid":
        x_bd = warp_trigger(xb, G(xb), grid_rescale=cfg.grid_rescale)
    else:
        g_args = (torch.full((xb.shape[0],), cfg.target_label, device=xb.device),) if spec.conditional else ()
        x_bd = _trigger_fn(cfg)(xb, G(xb, *g_args), sigma_draw=sigma_draw)
    return torch.cat([xb, x_bd], dim=2)


def run_alternated(cfg: Config, spec: AlternatedSpec):
    return run_on_world(_run_alternated, cfg, spec)


def _run_alternated(cfg: Config, world: World, spec: AlternatedSpec):
    device = world.device
    imgs, labs = device_dataset(cfg, device, True)
    timgs, tlabs = device_dataset(cfg, device, False)
    spe = steps_per_epoch(imgs.shape[0], cfg.bs)

    torch.manual_seed(cfg.seed)
    C = get_classifier(cfg).to(device)
    G = get_generator(cfg, spec.generator_kind).to(device)
    netF = freeze(get_frequency_detector(cfg).to(device))
    clean_model = freeze(get_classifier(cfg).to(device))
    stateC = TrainState(C, multistep_lr(cfg.lr_C, cfg.schedulerC_milestones, cfg.schedulerC_lambda, spe), world)
    g_lr, g_milestones, g_gamma = _g_schedule_args(cfg, spec)
    stateG = TrainState(G, multistep_lr(g_lr, g_milestones, g_gamma, spe), world)

    mode = cfg.saving_prefix or spec.name
    path = ckpt_path(cfg.checkpoints, f"{mode}_clean", cfg.dataset)
    ckpt_folder = os.path.dirname(path)

    # frozen frequency detector (reference train_generator.py:503-512)
    f_ckpt = detector_path(cfg)
    print(f"Loading {cfg.F_model} at {f_ckpt}")
    f_detector_loaded = os.path.exists(f_ckpt)
    if f_detector_loaded:
        netF.load_state_dict(load_checkpoint(f_ckpt, map_location=device)["netC"])
        print("Done")
    else:
        # recorded in the log and the checkpoint, so a random-init detector
        # cannot pass for a meaningful F Acc
        print(f"WARNING: frequency-detector checkpoint not found at {f_ckpt}; "
              "F Acc metrics will be meaningless (random-init detector).")

    # frozen clean model (reference train_generator.py:514-527)
    if not cfg.load_checkpoint_clean:
        raise SystemExit("--load_checkpoint_clean is required (clean-classifier run prefix)")
    clean_path = ckpt_path(cfg.checkpoints, cfg.load_checkpoint_clean, cfg.dataset)
    if not os.path.exists(clean_path):
        raise SystemExit(f"Error: {clean_path} not found")
    clean_model.load_state_dict(load_checkpoint(clean_path, map_location=device)["netC"])

    # warm-start G: the multilabel victim continues alternated training
    # (reference train_victim_multilabel.py:495-520)
    if spec.load_g:
        if not cfg.load_checkpoint:
            raise SystemExit("--load_checkpoint is required (generator run name)")
        g_path = ckpt_path(cfg.checkpoints, cfg.load_checkpoint, cfg.dataset)
        if not os.path.exists(g_path):
            raise SystemExit(f"Error: {g_path} not found")
        G.load_state_dict(load_checkpoint(g_path, map_location=device)["netG"])

    best_keys = BASE_BEST_KEYS + (("best_cross_acc",) if spec.track_cross else ())
    best = {k: 0.0 for k in best_keys}
    epoch_current = 0
    extra = spec.extra_ckpt(cfg) if spec.extra_ckpt else {}

    def payload_of(epoch):
        return {
            "netC": C.state_dict(),
            "schedulerC": {"step": stateC.step},
            "optimizerC": stateC.optimizer.state_dict(),
            "netG": G.state_dict(),
            "schedulerG": {"step": stateG.step},
            "optimizerG": stateG.optimizer.state_dict(),
            "clean_model": clean_model.state_dict(),
            **best,
            **extra,
            "F_detector_loaded": f_detector_loaded,
            "scheduler_steps_per_epoch": spe,
            "epoch_current": epoch,
        }

    if cfg.continue_training:
        if not os.path.exists(path):
            raise SystemExit("Pretrained model doesnt exist")
        print("Continue training!!")
        payload = load_checkpoint(path, map_location=device)
        warn_on_cadence_change(payload, spe)
        epochs_done = int(payload["epoch_current"]) + 1
        for state, key, lr, milestones, gamma in (
            (stateC, "C", cfg.lr_C, cfg.schedulerC_milestones, cfg.schedulerC_lambda),
            (stateG, "G", g_lr, g_milestones, g_gamma),
        ):
            state.model.load_state_dict(payload[f"net{key}"])
            state.optimizer.load_state_dict(payload[f"optimizer{key}"])
            state.step = int(payload[f"scheduler{key}"]["step"])
            state.schedule = multistep_lr_resume(lr, milestones, gamma, spe, epochs_done, state.step)
        clean_model.load_state_dict(payload["clean_model"])
        best = {k: float(payload[k]) for k in best_keys}
        epoch_current = epochs_done
        log_dir = run_dirs(cfg, world, ckpt_folder, fresh=False)
    else:
        print("Train from scratch!!!")
        log_dir = run_dirs(cfg, world, ckpt_folder, fresh=True)
    for model in (C, G, netF, clean_model):  # built and loaded alike on every rank; rank 0's, exactly
        replicate(model, world)

    logger = run_logger(world, log_dir)
    logger.log(epoch_current, {"F_detector_loaded": int(f_detector_loaded)}, group="meta")
    train_step = spec.make_train_step(cfg, C, G)
    eval_step = spec.make_eval_step(cfg, C, G)
    epoch_runner = train_epoch_alternated_pair if spec.pair else train_epoch_alternated

    for epoch in range(epoch_current, cfg.n_iters):
        with Timer() as t, profile_epoch(cfg.profile_dir if world.is_main else "", epoch, epoch_current, device):
            m = metrics_to_host(
                epoch_runner(train_step, stateC, stateG, clean_model, netF, imgs, labs,
                             epoch_generator(cfg.seed, TRAIN_STREAM, epoch, device), cfg.bs, world=world)
            )
        n = m["sample"]  # the global batch's rows
        ips = n / t.seconds
        line = (
            f"Epoch {epoch + 1}: Clean Acc: {fmt_pct(m['clean_correct'] * 100 / n)} | "
            f"Bd Acc: {fmt_pct(m['bd_correct'] * 100 / n)} | F Acc: {fmt_pct(m['F_correct'] * 100 / n)}"
        )
        if spec.track_cross:
            line += f" | Cross Acc: {fmt_pct(m['cross_correct'] * 100 / n)}"
        print(
            line + f" | Clean Model Acc: {fmt_pct(m['clean_model_correct'] * 100 / n)} | "
            f"Clean Model Bd BA: {fmt_pct(m['clean_model_bd_ba'] * 100 / n)} | "
            f"Clean Model Bd ASR: {fmt_pct(m['clean_model_bd_asr'] * 100 / n)} | {ips:.0f} img/s"
        )
        logger.log(epoch, {k: v for k, v in m.items() if k != "sample"} | {"images_per_sec": ips})

        em = metrics_to_host(
            eval_epoch(eval_step, (clean_model, netF), timgs, tlabs, cfg.bs, with_pair=spec.pair, world=world,
                       generator=epoch_generator(cfg.seed, EVAL_STREAM, epoch, device))
        )
        cs, bs_ = em["clean_sample"], max(em["bd_sample"], 1.0)
        acc_clean = em["clean_correct"] * 100 / cs
        acc_bd = em["bd_correct"] * 100 / bs_
        # multilabel counts F over all rows on each class pass (reference :378)
        acc_F = em["F_correct"] * 100 / (cs * cfg.num_classes if spec.conditional else bs_)
        acc_cm = em["clean_model_correct"] * 100 / cs
        ba_cm = em["clean_model_bd_ba"] * 100 / bs_
        asr_cm = em["clean_model_bd_asr"] * 100 / bs_
        eval_line = (
            f"  Eval: Clean Acc: {fmt_pct(acc_clean)} - Best: {fmt_pct(best['best_clean_acc'])} | "
            f"Bd Acc: {fmt_pct(acc_bd)} - Best: {fmt_pct(best['best_bd_acc'])} | F Acc: {fmt_pct(acc_F)}"
        )
        scalars = {"Clean": acc_clean, "Bd": acc_bd, "F": acc_F, "Clean Model Acc": acc_cm,
                   "Clean Model Bd BA": ba_cm, "Clean Model Bd ASR": asr_cm}
        if spec.track_cross:
            cross = em["cross_correct"] * 100 / bs_
            eval_line += f" | Cross Acc: {fmt_pct(cross)}"
            scalars["Cross"] = cross
        print(eval_line)
        logger.log(epoch, scalars, group="test")
        if cfg.image_every and epoch % cfg.image_every == 0 and logger.writes_images:
            sigma = draw_sigma(cfg.sigma, epoch_generator(cfg.seed, GRID_STREAM, epoch, device), device)
            logger.log_images(epoch, image_grid(cfg, spec, G, timgs, sigma))
        if best_gate_attack(acc_clean, acc_bd, best["best_clean_acc"], best["best_bd_acc"]):
            print(" Saving...")
            best.update(dict(zip(BASE_BEST_KEYS, (acc_clean, acc_bd, acc_F, acc_cm, ba_cm, asr_cm))))
            if spec.track_cross:
                best["best_cross_acc"] = cross
            save_on_main(world, path, lambda: payload_of(epoch))
    logger.close()
    return best
