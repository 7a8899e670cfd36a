"""Train and eval steps (the port of ``combat_tpu/train/steps.py``).

The reference's per-batch loop (``train_generator.py:170-290``) runs the
generator twice per batch.  Here it runs once: the C-step takes
``noise.detach()`` and the G-loss backpropagates through the same ``noise``,
the autograd counterpart of the JAX package's ``jax.vjp`` sharing.

BatchNorm modes follow the reference's ``.train()/.eval()`` toggles: the
C-step updates C's batch statistics, and the G-step runs C in eval mode on
the just-updated statistics, so G's gradient flows through a frozen-BN C.

Every random draw of a step can be passed in (:class:`AlternatedDraws`,
:class:`VictimDraws`, :class:`~combat_tpu_torch.ops.augment.AugDraws`, a
sigma); absent, the step
draws from the ``torch.Generator`` it is given.  A step updates its models
and optimizers in place and returns its metrics as 0-d tensors on the
batch's device.

A detector whose dropout stays live in eval mode (``--F_model
original_dropout``, ``original_dropout_ensemble``) takes its masks in the
role ``drop_F`` (the JAX steps' dropout key, ``k[8]`` of the alternated step,
``k[1]`` of the eval step), drawn after every other role and only for such a
detector, so every other configuration draws exactly as before.

A classifier whose dropout is live in train mode (mnist's ``NetC_MNIST``) is
refused by every training step (:func:`refuse_train_dropout`), where the
JAX package's C-steps stop too: they apply C with ``train=True`` and pass no
``dropout`` rng.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..attack.triggers import additive_trigger, create_targets_bd
from ..config import Config
from ..models.layers import Dropout, live_dropout
from ..ops.augment import AugDraws, draw_augment, post_tensor_transform
from ..ops.blur import draw_sigma
from ..ops.dct import detector_features
from .state import TrainState

Metrics = Dict[str, torch.Tensor]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels.long())


def _aug_fn(cfg: Config):
    return partial(
        post_tensor_transform,
        crop_padding=cfg.random_crop,
        rotation_degrees=float(cfg.random_rotation),
        hflip=cfg.dataset == "cifar10",
        option=cfg.post_transform_option,
    )


def _trigger_fn(cfg: Config):
    return partial(
        additive_trigger,
        image_size=cfg.input_height,
        ratio=cfg.ratio,
        noise_rate=cfg.noise_rate,
        kernel_size=cfg.kernel_size,
        sigma=cfg.sigma,
        fused=cfg.pallas_trigger,
        lowfreq_kernel=cfg.pallas_lowfreq,
    )


def _draw_aug(cfg: Config, n: int, generator, device) -> AugDraws:
    return draw_augment(n, generator, device, cfg.random_crop, float(cfg.random_rotation))


def grad_l2_metric(x: torch.Tensor, x_bd: torch.Tensor) -> torch.Tensor:
    """The reference's computed-but-unused gradient-L2 loss, kept as a metric
    (``train_generator.py:235-243``: pad (1,1,2,1), MSE of adjacent diffs
    along H and W)."""
    xe, be = F.pad(x, (1, 1, 2, 1)), F.pad(x_bd, (1, 1, 2, 1))
    dh = torch.mean((xe[:, :, 1:] - xe[:, :, :-1] - (be[:, :, 1:] - be[:, :, :-1])) ** 2)
    dw = torch.mean((xe[..., 1:] - xe[..., :-1] - (be[..., 1:] - be[..., :-1])) ** 2)
    return dh + dw


def full_metrics_mode(cfg: Config) -> bool:
    """True for per-batch train metrics (reference parity), False for
    ``loss_only``; anything else is an error."""
    if cfg.train_metrics not in ("full", "loss_only"):
        raise ValueError(f"train_metrics must be 'full' or 'loss_only', got {cfg.train_metrics!r}")
    return cfg.train_metrics == "full"


def refuse_train_dropout(C: nn.Module) -> None:
    """A ``NotImplementedError`` for a classifier with dropout that is live
    in train mode, as the JAX C-steps stop on it with ``InvalidRngError``."""
    if any(isinstance(m, Dropout) and m.p > 0.0 for m in C.modules()):
        raise NotImplementedError(
            f"{type(C).__name__} has dropout that is live in train mode: the JAX package's C-steps apply the "
            "classifier with train=True and pass no 'dropout' rng (combat_tpu/train/steps.py:155-157,271-273), "
            "so they stop there (flax.errors.InvalidRngError); training it needs a role for its masks that "
            "neither package has"
        )


DetectorMasks = Optional[List[torch.Tensor]]


def draw_drop_F(netF: nn.Module, n: int, generator: Optional[torch.Generator], device) -> DetectorMasks:
    """The detector's dropout masks for a forward on ``n`` rows where its
    dropout is live in its mode (the eval-live detectors), else None with
    nothing drawn."""
    return netF.draw_masks(n, generator, device) if live_dropout(netF) else None


def detector_logits(netF: nn.Module, x_bd: torch.Tensor, drop_F: DetectorMasks = None) -> torch.Tensor:
    """The detector on the DCT features of ``x_bd``, with its masks."""
    feats = detector_features(x_bd)
    return netF(feats) if drop_F is None else netF(feats, drop_F)


def _count(pred: torch.Tensor, target: torch.Tensor, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    hit = (pred.argmax(-1) == target).float()
    return (hit if weight is None else hit * weight).sum()


# --------------------------------------------------------------------------
# Alternated attack training (reference train_generator.py:131-318)
# --------------------------------------------------------------------------


class AlternatedDraws(NamedTuple):
    """The random draws of one alternated step, in the roles of the JAX
    step's subkeys ``k[0..8]``."""

    sigma_c: torch.Tensor  # k[0]: blur sigma of the C-step trigger
    poison: torch.Tensor  # k[1]: (n,) Bernoulli(pc), and-ed with the target-class rows
    aug_c: AugDraws  # k[2]: augmentation of the C-step batch
    aug_cm: AugDraws  # k[3]: clean-model metric forward
    sigma_g: torch.Tensor  # k[4]: blur sigma of the G-step trigger
    aug_g: AugDraws  # k[5]: C's input in the G-loss
    aug_g_cm: AugDraws  # k[6]: the clean model's input in the G-loss
    aug_clean: AugDraws  # k[7]: C's clean-accuracy metric forward
    drop_F: DetectorMasks = None  # k[8]: the detector's dropout masks (eval-live detectors only)


def draw_alternated(
    cfg: Config, n: int, generator: Optional[torch.Generator], device, netF: Optional[nn.Module] = None
) -> AlternatedDraws:
    """Every draw is made in both metric modes, so ``loss_only`` and
    ``full`` follow the same trajectory from the same generator; the
    detector's masks last, for an eval-live ``netF`` only."""
    return AlternatedDraws(
        sigma_c=draw_sigma(cfg.sigma, generator, device),
        poison=torch.rand((n,), generator=generator, device=device) < cfg.pc,
        aug_c=_draw_aug(cfg, n, generator, device),
        aug_cm=_draw_aug(cfg, n, generator, device),
        sigma_g=draw_sigma(cfg.sigma, generator, device),
        aug_g=_draw_aug(cfg, n, generator, device),
        aug_g_cm=_draw_aug(cfg, n, generator, device),
        aug_clean=_draw_aug(cfg, n, generator, device),
        drop_F=None if netF is None else draw_drop_F(netF, n, generator, device),
    )


def make_alternated_train_step(cfg: Config, C: nn.Module, G: nn.Module):
    refuse_train_dropout(C)
    aug = _aug_fn(cfg)
    trig = _trigger_fn(cfg)
    full_metrics = full_metrics_mode(cfg)

    def step(
        stateC: TrainState,
        stateG: TrainState,
        clean_model: nn.Module,
        netF: nn.Module,
        batch,
        generator: Optional[torch.Generator] = None,
        draws: Optional[AlternatedDraws] = None,
    ) -> Metrics:
        x, y = batch
        bs = x.shape[0]
        if draws is None:
            draws = draw_alternated(cfg, bs, generator, x.device, netF)
        bd_targets = create_targets_bd(y, cfg.attack_mode, cfg.target_label, cfg.num_classes)

        G.train()
        noise = G(x)  # the one generator forward of the step

        # ---- C-step (G frozen, C in train mode) ----
        with torch.no_grad():
            x_bd_c = trig(x, noise.detach(), sigma_draw=draws.sigma_c)
            poison = (y == bd_targets) & draws.poison
            x_mix = torch.where(poison[:, None, None, None], x_bd_c, x)
            x_mix = aug(x_mix, draws.aug_c)
        C.train()
        stateC.zero_grad()
        # poisoned rows keep their (clean == target-class) labels
        cross_entropy(C(x_mix), y).backward()
        stateC.apply_gradients()

        if full_metrics:  # clean-model forward on augmented clean inputs (:214)
            with torch.no_grad():
                clean_preds = clean_model(aug(x, draws.aug_cm))

        # ---- G-step (C in eval mode on its just-updated statistics) ----
        C.eval()
        x_bd = trig(x, noise, sigma_draw=draws.sigma_g)
        pred_bd = C(aug(x_bd, draws.aug_g))
        l_ce = cross_entropy(pred_bd, bd_targets)
        l_l2 = torch.mean((x_bd - x) ** 2)
        cm_bd = clean_model(aug(x_bd, draws.aug_g_cm))
        l_cm = cross_entropy(cm_bd, y)
        total = l_ce + cfg.L2_weight * l_l2 + cfg.clean_model_weight * l_cm
        stateG.apply_gradients(torch.autograd.grad(total, list(G.parameters())))

        with torch.no_grad():
            x_bd = x_bd.detach()
            zero = x.new_zeros(())
            if full_metrics:
                pred_clean = C(aug(x, draws.aug_clean))
                pred_F = detector_logits(netF, x_bd, draws.drop_F)
            return {
                "sample": x.new_tensor(float(bs)),
                "loss_ce": l_ce.detach(),
                "loss_l2": l_l2.detach(),
                "loss_grad_l2": grad_l2_metric(x, x_bd),
                "clean_model_loss": l_cm.detach(),
                "clean_correct": _count(pred_clean, y) if full_metrics else zero,
                "bd_correct": _count(pred_bd, bd_targets),
                "F_correct": _count(pred_F, torch.ones_like(y)) if full_metrics else zero,
                "clean_model_correct": _count(clean_preds, y) if full_metrics else zero,
                "clean_model_bd_ba": _count(cm_bd, y),
                "clean_model_bd_asr": _count(cm_bd, bd_targets),
            }

    return step


def attack_eval_metrics(cfg: Config, C, clean_model, netF, x, y, valid, x_bd, drop_F: DetectorMasks = None) -> Metrics:
    """Clean, backdoor, detector and clean-model counts of an attack eval
    batch, in eval mode: clean counts over the valid rows, the rest over
    the valid non-target rows.  ``drop_F``: the detector's masks, if any."""
    bd_targets = create_targets_bd(y, cfg.attack_mode, cfg.target_label, cfg.num_classes)
    vf, nf = valid.float(), ((y != cfg.target_label) & valid).float()
    cm_bd = clean_model(x_bd)
    return {
        "clean_sample": vf.sum(),
        "bd_sample": nf.sum(),
        "clean_correct": _count(C(x), y, vf),
        "bd_correct": _count(C(x_bd), bd_targets, nf),
        "F_correct": _count(detector_logits(netF, x_bd, drop_F), torch.ones_like(y), nf),
        "clean_model_correct": _count(clean_model(x), y, vf),
        "clean_model_bd_ba": _count(cm_bd, y, nf),
        "clean_model_bd_asr": _count(cm_bd, bd_targets, nf),
    }


def make_attack_eval_step(cfg: Config, C: nn.Module, G: nn.Module):
    """Eval-side metrics over non-target test rows
    (reference ``train_generator.py:321-431``)."""
    trig = _trigger_fn(cfg)

    @torch.no_grad()
    def step(
        clean_model: nn.Module,
        netF: nn.Module,
        batch,
        generator: Optional[torch.Generator] = None,
        sigma_draw: Optional[torch.Tensor] = None,
        drop_F: DetectorMasks = None,
    ) -> Metrics:
        """``sigma_draw`` and ``drop_F`` take the roles of the JAX step's
        ``k[0]`` and ``k[1]``; absent, each is drawn from ``generator`` in
        that order."""
        x, y, valid = batch
        C.eval()
        G.eval()
        x_bd = trig(x, G(x), sigma_draw=sigma_draw, generator=generator)
        if drop_F is None:
            drop_F = draw_drop_F(netF, x.shape[0], generator, x.device)
        return attack_eval_metrics(cfg, C, clean_model, netF, x, y, valid, x_bd, drop_F)

    return step


# --------------------------------------------------------------------------
# Clean classifier training (reference train_clean_classifier.py:75-161)
# --------------------------------------------------------------------------


def make_clean_train_step(cfg: Config, C: nn.Module):
    refuse_train_dropout(C)
    aug = _aug_fn(cfg)

    def step(
        stateC: TrainState, batch, generator: Optional[torch.Generator] = None, draws: Optional[AugDraws] = None
    ) -> Metrics:
        x, y = batch
        if draws is None:
            draws = _draw_aug(cfg, x.shape[0], generator, x.device)
        with torch.no_grad():
            x_aug = aug(x, draws)
        C.train()
        stateC.zero_grad()
        logits = C(x_aug)
        loss = cross_entropy(logits, y)
        loss.backward()
        stateC.apply_gradients()
        return {
            "sample": x.new_tensor(float(x.shape[0])),
            "loss_ce": loss.detach(),
            "clean_correct": _count(logits.detach(), y),
        }

    return step


def make_clean_eval_step(C: nn.Module):
    @torch.no_grad()
    def step(batch) -> Metrics:
        x, y, valid = batch
        C.eval()
        vf = valid.float()
        return {"clean_sample": vf.sum(), "clean_correct": _count(C(x), y, vf)}

    return step


# --------------------------------------------------------------------------
# Victim training on a fixed poisoned subset (reference train_victim.py:93-231)
# --------------------------------------------------------------------------


class VictimDraws(NamedTuple):
    """The random draws of one victim step, in the roles of the JAX step's
    subkeys ``k[0..1]``."""

    sigma: torch.Tensor  # k[0]: blur sigma of the trigger
    aug: AugDraws  # k[1]: augmentation of the mixed batch


def draw_victim(cfg: Config, n: int, generator: Optional[torch.Generator], device) -> VictimDraws:
    return VictimDraws(sigma=draw_sigma(cfg.sigma, generator, device), aug=_draw_aug(cfg, n, generator, device))


def make_victim_train_step(cfg: Config, C: nn.Module, G: nn.Module):
    """One SGD step of C on the batch with its poisoned rows (the fixed mask
    of :func:`~combat_tpu_torch.data.poison_flags`) replaced by their
    triggered images and backdoor labels.  G is frozen: it runs in eval mode
    without a gradient, so the fused trigger launches its forward kernel
    only."""
    refuse_train_dropout(C)
    aug = _aug_fn(cfg)
    trig = _trigger_fn(cfg)

    def step(
        stateC: TrainState, batch, generator: Optional[torch.Generator] = None, draws: Optional[VictimDraws] = None
    ) -> Metrics:
        x, y, poisoned = batch
        if draws is None:
            draws = draw_victim(cfg, x.shape[0], generator, x.device)
        bd_targets = create_targets_bd(y, cfg.attack_mode, cfg.target_label, cfg.num_classes)
        with torch.no_grad():
            G.eval()
            x_bd = trig(x, G(x), sigma_draw=draws.sigma)
            x_mix = aug(torch.where(poisoned[:, None, None, None], x_bd, x), draws.aug)
        labels = torch.where(poisoned, bd_targets, y)
        C.train()
        stateC.zero_grad()
        logits = C(x_mix)
        loss = cross_entropy(logits, labels)
        loss.backward()
        stateC.apply_gradients()
        return {
            "sample": x.new_tensor(float(x.shape[0])),
            "loss_ce": loss.detach(),
            "clean_correct": _count(logits.detach(), labels),
        }

    return step


def backdoor_eval_forward(cfg: Config, C: nn.Module, G: nn.Module, trig, batch, generator, sigma_draw):
    """C's logits on the clean and the triggered batch, the backdoor
    targets, and the float masks of the valid rows and of the valid
    non-target rows (the rows backdoor metrics count), in eval mode."""
    x, y, valid = batch
    C.eval()
    G.eval()
    bd_targets = create_targets_bd(y, cfg.attack_mode, cfg.target_label, cfg.num_classes)
    preds_clean = C(x)
    preds_bd = C(trig(x, G(x), sigma_draw=sigma_draw, generator=generator))
    return preds_clean, preds_bd, bd_targets, valid.float(), ((y != cfg.target_label) & valid).float()


def make_victim_eval_step(cfg: Config, C: nn.Module, G: nn.Module):
    """Clean accuracy over valid rows, ASR over valid non-target rows, one
    sigma a batch (reference ``train_victim.py:168-231``)."""
    trig = _trigger_fn(cfg)

    @torch.no_grad()
    def step(batch, generator: Optional[torch.Generator] = None, sigma_draw: Optional[torch.Tensor] = None) -> Metrics:
        preds_clean, preds_bd, bd_targets, vf, nf = backdoor_eval_forward(
            cfg, C, G, trig, batch, generator, sigma_draw
        )
        return {
            "clean_sample": vf.sum(),
            "bd_sample": nf.sum(),
            "clean_correct": _count(preds_clean, batch[1], vf),
            "bd_correct": _count(preds_bd, bd_targets, nf),
        }

    return step
