"""Trigger-variant train and eval steps (the port of
``combat_tpu/train/variants.py``): WaNet warp, input-aware cross trigger,
imperceptible (total variation), class-conditional multilabel.

Each follows the alternated step of ``steps.py``: a C-step on Bernoulli(pc)
poisoned rows with clean labels, then a G-step against C in eval mode on
its just-updated statistics and the frozen clean model, with the detector's
evasion as a metric only.  The per-variant deltas:

  wanet:         trigger = grid_sample(x, clamp(id*(1-r) + upsample(flow)*r));
                 G's L2 term is MSE(flow_up, 0) (reference
                 ``train_generator_wanet.py:212``)
  inputaware:    a second independent batch x2; the cross loss
                 ``cross_weight * CE(C(aug(trigger of G(x2) on x)), y)``
                 (``train_generator_inputaware.py:236-266``)
  imperceptible: + ``tv_weight * total_variation(x_bd).mean()``
                 (``train_generator_imperceptible.py:228-237``)
  multilabel:    G(x, class); the C-step poisons Bernoulli(pc) rows of any
                 class toward their own label; the G-step gives row i the
                 target ``min(i // ceil(bs/K), K-1)``; eval runs every class

One G forward serves both halves of a step where the inputs agree (the
C-step takes it detached), as in ``steps.py``; input-aware's G(x2) and the
multilabel G-step (another label map) keep their own forwards.

Every random draw can be passed in as a ``NamedTuple`` named by role (the
imperceptible and multilabel steps draw in the roles of
:class:`~combat_tpu_torch.train.steps.AlternatedDraws`); absent, the step
draws from the ``torch.Generator`` it is given.  An eval-live detector's
masks take the role ``drop_F``, drawn last and only for such a detector
(``steps.py``); the eval steps take them as an argument.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..attack.triggers import create_targets_bd, warp_flow, warp_grid
from ..config import Config
from ..ops.augment import AugDraws
from ..ops.blur import draw_sigma
from ..ops.image import grid_sample, total_variation
from .state import TrainState
from .steps import (
    AlternatedDraws,
    DetectorMasks,
    Metrics,
    _aug_fn,
    _count,
    _draw_aug,
    _trigger_fn,
    attack_eval_metrics,
    cross_entropy,
    detector_logits,
    draw_alternated,
    draw_drop_F,
    full_metrics_mode,
    grad_l2_metric,
    refuse_train_dropout,
)


def _c_step(stateC: TrainState, C: nn.Module, x_mix: torch.Tensor, y: torch.Tensor) -> None:
    """One SGD step of C in train mode on the mixed batch with clean labels."""
    C.train()
    stateC.zero_grad()
    cross_entropy(C(x_mix), y).backward()
    stateC.apply_gradients()


def _attack_counts(pred_bd, cm_bd, y, bd_targets) -> Metrics:
    return {
        "bd_correct": _count(pred_bd, bd_targets),
        "clean_model_bd_ba": _count(cm_bd, y),
        "clean_model_bd_asr": _count(cm_bd, bd_targets),
    }


def _clean_model_preds(full_metrics, clean_model, aug, x, aug_cm) -> Optional[torch.Tensor]:
    """The clean model on augmented clean inputs, a metric only (None in
    ``loss_only`` mode)."""
    if not full_metrics:
        return None
    with torch.no_grad():
        return clean_model(aug(x, aug_cm))


def _metric_counts(C, netF, aug, x, y, x_bd, aug_clean, clean_preds, drop_F: DetectorMasks) -> Metrics:
    """The metric-only counts of a step, zeros when ``clean_preds`` is None
    (``loss_only`` mode)."""
    if clean_preds is None:
        zero = x.new_zeros(())
        return {"clean_correct": zero, "F_correct": zero, "clean_model_correct": zero}
    return {
        "clean_correct": _count(C(aug(x, aug_clean)), y),
        "F_correct": _count(detector_logits(netF, x_bd, drop_F), torch.ones_like(y)),
        "clean_model_correct": _count(clean_preds, y),
    }


# --------------------------------------------------------------------------
# WaNet (warp trigger)
# --------------------------------------------------------------------------


def wanet_apply(x: torch.Tensor, flow: torch.Tensor, grid_rescale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the warped batch, the upsampled flow in the (B, H, W, 2) layout)."""
    flow_up = warp_flow(flow, x.shape[-2], x.shape[-1])
    return grid_sample(x, warp_grid(flow_up, grid_rescale), align_corners=True), flow_up


def _wanet_grad_l2(flow_up: torch.Tensor) -> torch.Tensor:
    """The reference's metric (``train_generator_wanet.py:213-222``):
    ``F.pad(noise_grid, (1,1,2,1))`` on the permuted (B, H, W, 2) tensor pads
    the xy axis by (1, 1) and W by (2, 1); the diffs run along W and xy."""
    a = F.pad(flow_up, (1, 1, 2, 1))
    return torch.mean((a[:, :, 1:] - a[:, :, :-1]) ** 2) + torch.mean((a[..., 1:] - a[..., :-1]) ** 2)


class WanetDraws(NamedTuple):
    """The draws of one WaNet step, in the roles of the JAX step's subkeys
    ``k[0..6]`` (no trigger sigma: the warp does not blur)."""

    poison: torch.Tensor  # k[0]: (n,) Bernoulli(pc), and-ed with the target-class rows
    aug_c: AugDraws  # k[1]: augmentation of the C-step batch
    aug_cm: AugDraws  # k[2]: clean-model metric forward
    aug_g: AugDraws  # k[3]: C's input in the G-loss
    aug_g_cm: AugDraws  # k[4]: the clean model's input in the G-loss
    aug_clean: AugDraws  # k[5]: C's clean-accuracy metric forward
    drop_F: DetectorMasks = None  # k[6]: the detector's dropout masks (eval-live detectors only)


def draw_wanet(cfg: Config, n: int, generator: Optional[torch.Generator], device, netF=None) -> WanetDraws:
    return WanetDraws(
        poison=torch.rand((n,), generator=generator, device=device) < cfg.pc,
        aug_c=_draw_aug(cfg, n, generator, device),
        aug_cm=_draw_aug(cfg, n, generator, device),
        aug_g=_draw_aug(cfg, n, generator, device),
        aug_g_cm=_draw_aug(cfg, n, generator, device),
        aug_clean=_draw_aug(cfg, n, generator, device),
        drop_F=None if netF is None else draw_drop_F(netF, n, generator, device),
    )


def make_wanet_train_step(cfg: Config, C: nn.Module, G: nn.Module):
    refuse_train_dropout(C)
    aug = _aug_fn(cfg)
    full_metrics = full_metrics_mode(cfg)

    def step(stateC, stateG, clean_model, netF, batch, generator=None, draws: Optional[WanetDraws] = None) -> Metrics:
        x, y = batch
        bs = x.shape[0]
        if draws is None:
            draws = draw_wanet(cfg, bs, generator, x.device, netF)
        bd_targets = create_targets_bd(y, cfg.attack_mode, cfg.target_label, cfg.num_classes)
        G.train()
        flow = G(x)  # the one generator forward of the step

        with torch.no_grad():
            x_bd_c, _ = wanet_apply(x, flow.detach(), cfg.grid_rescale)
            poison = (y == bd_targets) & draws.poison
            x_mix = aug(torch.where(poison[:, None, None, None], x_bd_c, x), draws.aug_c)
        _c_step(stateC, C, x_mix, y)
        clean_preds = _clean_model_preds(full_metrics, clean_model, aug, x, draws.aug_cm)

        C.eval()
        x_bd, flow_up = wanet_apply(x, flow, cfg.grid_rescale)
        pred_bd = C(aug(x_bd, draws.aug_g))
        l_ce = cross_entropy(pred_bd, bd_targets)
        l_l2 = torch.mean(flow_up**2)  # MSE(noise_grid, 0)
        cm_bd = clean_model(aug(x_bd, draws.aug_g_cm))
        l_cm = cross_entropy(cm_bd, y)
        total = l_ce + cfg.L2_weight * l_l2 + cfg.clean_model_weight * l_cm
        stateG.apply_gradients(torch.autograd.grad(total, list(G.parameters())))

        with torch.no_grad():
            return {
                "sample": x.new_tensor(float(bs)),
                "loss_ce": l_ce.detach(),
                "loss_l2": l_l2.detach(),
                "loss_grad_l2": _wanet_grad_l2(flow_up.detach()),
                "clean_model_loss": l_cm.detach(),
                **_metric_counts(C, netF, aug, x, y, x_bd.detach(), draws.aug_clean, clean_preds, draws.drop_F),
                **_attack_counts(pred_bd, cm_bd, y, bd_targets),
            }

    return step


def make_wanet_eval_step(cfg: Config, C: nn.Module, G: nn.Module):
    @torch.no_grad()
    def step(clean_model, netF, batch, generator=None, drop_F: DetectorMasks = None) -> Metrics:
        """``drop_F``: the detector's masks (the JAX step's ``key``)."""
        x, y, valid = batch
        C.eval()
        G.eval()
        x_bd, _ = wanet_apply(x, G(x), cfg.grid_rescale)
        if drop_F is None:
            drop_F = draw_drop_F(netF, x.shape[0], generator, x.device)
        return attack_eval_metrics(cfg, C, clean_model, netF, x, y, valid, x_bd, drop_F)

    return step


# --------------------------------------------------------------------------
# Input-aware (cross-trigger non-reusability)
# --------------------------------------------------------------------------


class InputawareDraws(NamedTuple):
    """The draws of one input-aware step, in the roles of the JAX step's
    subkeys ``k[0..9]``."""

    sigma_c: torch.Tensor  # k[0]: blur sigma of the C-step trigger
    poison: torch.Tensor  # k[1]: (n,) Bernoulli(pc), and-ed with the target-class rows
    aug_c: AugDraws  # k[2]: augmentation of the C-step batch
    aug_cm: AugDraws  # k[3]: clean-model metric forward
    sigma_g: torch.Tensor  # k[4]: blur sigma of G(x)'s trigger in the G-loss
    sigma_cross: torch.Tensor  # k[5]: blur sigma of the cross trigger G(x2) on x
    aug_g: AugDraws  # k[6]: C's input in the G-loss
    aug_cross: AugDraws  # k[7]: C's input of the cross loss
    aug_g_cm: AugDraws  # k[8]: the clean model's input in the G-loss
    aug_clean: AugDraws  # k[9]: C's clean-accuracy metric forward
    drop_F: DetectorMasks = None  # k[0] again: the detector's dropout masks (eval-live detectors only)


def draw_inputaware(cfg: Config, n: int, generator: Optional[torch.Generator], device, netF=None) -> InputawareDraws:
    return InputawareDraws(
        sigma_c=draw_sigma(cfg.sigma, generator, device),
        poison=torch.rand((n,), generator=generator, device=device) < cfg.pc,
        aug_c=_draw_aug(cfg, n, generator, device),
        aug_cm=_draw_aug(cfg, n, generator, device),
        sigma_g=draw_sigma(cfg.sigma, generator, device),
        sigma_cross=draw_sigma(cfg.sigma, generator, device),
        aug_g=_draw_aug(cfg, n, generator, device),
        aug_cross=_draw_aug(cfg, n, generator, device),
        aug_g_cm=_draw_aug(cfg, n, generator, device),
        aug_clean=_draw_aug(cfg, n, generator, device),
        drop_F=None if netF is None else draw_drop_F(netF, n, generator, device),
    )


def make_inputaware_train_step(cfg: Config, C: nn.Module, G: nn.Module):
    refuse_train_dropout(C)
    aug = _aug_fn(cfg)
    trig = _trigger_fn(cfg)
    full_metrics = full_metrics_mode(cfg)

    def step(stateC, stateG, clean_model, netF, batch, generator=None,
             draws: Optional[InputawareDraws] = None) -> Metrics:
        x, y, x2 = batch
        bs = x.shape[0]
        if draws is None:
            draws = draw_inputaware(cfg, bs, generator, x.device, netF)
        bd_targets = create_targets_bd(y, cfg.attack_mode, cfg.target_label, cfg.num_classes)
        G.train()
        noise = G(x)  # shared by the C-step (detached) and the G-loss
        noise2 = G(x2)

        with torch.no_grad():
            x_bd_c = trig(x, noise.detach(), sigma_draw=draws.sigma_c)
            poison = (y == bd_targets) & draws.poison
            x_mix = aug(torch.where(poison[:, None, None, None], x_bd_c, x), draws.aug_c)
        _c_step(stateC, C, x_mix, y)
        clean_preds = _clean_model_preds(full_metrics, clean_model, aug, x, draws.aug_cm)

        C.eval()
        x_bd = trig(x, noise, sigma_draw=draws.sigma_g)
        x_bd2 = trig(x, noise2, sigma_draw=draws.sigma_cross)  # G(x2)'s trigger on x
        pred_bd = C(aug(x_bd, draws.aug_g))
        pred_cross = C(aug(x_bd2, draws.aug_cross))
        l_ce = cross_entropy(pred_bd, bd_targets)
        l_cross = cross_entropy(pred_cross, y)
        l_l2 = torch.mean((x_bd - x) ** 2)
        cm_bd = clean_model(aug(x_bd, draws.aug_g_cm))
        l_cm = cross_entropy(cm_bd, y)
        total = l_ce + cfg.cross_weight * l_cross + cfg.L2_weight * l_l2 + cfg.clean_model_weight * l_cm
        stateG.apply_gradients(torch.autograd.grad(total, list(G.parameters())))

        with torch.no_grad():
            return {
                "sample": x.new_tensor(float(bs)),
                "loss_ce": l_ce.detach(),
                "loss_l2": l_l2.detach(),
                "loss_cross": l_cross.detach(),
                "clean_model_loss": l_cm.detach(),
                "cross_correct": _count(pred_cross, y),
                **_metric_counts(C, netF, aug, x, y, x_bd.detach(), draws.aug_clean, clean_preds, draws.drop_F),
                **_attack_counts(pred_bd, cm_bd, y, bd_targets),
            }

    return step


class PairSigmas(NamedTuple):
    """The blur sigmas of a cross-accuracy eval batch (the JAX step's
    ``k[0]``, ``k[1]``)."""

    sigma: torch.Tensor  # G(x)'s trigger on x
    sigma_cross: torch.Tensor  # G(x2)'s trigger on x


def draw_pair_sigmas(cfg: Config, generator: Optional[torch.Generator], device) -> PairSigmas:
    return PairSigmas(draw_sigma(cfg.sigma, generator, device), draw_sigma(cfg.sigma, generator, device))


def _pair_triggers(cfg, G, trig, x, x2, generator, draws: Optional[PairSigmas]):
    if draws is None:
        draws = draw_pair_sigmas(cfg, generator, x.device)
    return trig(x, G(x), sigma_draw=draws.sigma), trig(x, G(x2), sigma_draw=draws.sigma_cross)


def make_inputaware_eval_step(cfg: Config, C: nn.Module, G: nn.Module):
    """The attack eval plus cross accuracy against a second shuffled test
    stream (reference ``train_generator_inputaware.py:339-508``)."""
    trig = _trigger_fn(cfg)

    @torch.no_grad()
    def step(clean_model, netF, batch, generator=None, draws: Optional[PairSigmas] = None,
             drop_F: DetectorMasks = None) -> Metrics:
        """``drop_F``: the detector's masks (the JAX step's ``k[2]``), drawn
        after the sigmas."""
        x, y, x2, valid = batch
        C.eval()
        G.eval()
        x_bd, x_bd2 = _pair_triggers(cfg, G, trig, x, x2, generator, draws)
        if drop_F is None:
            drop_F = draw_drop_F(netF, x.shape[0], generator, x.device)
        m = attack_eval_metrics(cfg, C, clean_model, netF, x, y, valid, x_bd, drop_F)
        nf = ((y != cfg.target_label) & valid).float()
        return {**m, "cross_correct": _count(C(x_bd2), y, nf)}

    return step


# --------------------------------------------------------------------------
# Imperceptible (total-variation regularised)
# --------------------------------------------------------------------------


def make_imperceptible_train_step(cfg: Config, C: nn.Module, G: nn.Module):
    """The base alternated step with ``tv_weight * TV(x_bd).mean()`` in the
    G-loss; its draws take the roles of :class:`AlternatedDraws`."""
    refuse_train_dropout(C)
    aug = _aug_fn(cfg)
    trig = _trigger_fn(cfg)
    full_metrics = full_metrics_mode(cfg)

    def step(stateC, stateG, clean_model, netF, batch, generator=None,
             draws: Optional[AlternatedDraws] = None) -> Metrics:
        x, y = batch
        bs = x.shape[0]
        if draws is None:
            draws = draw_alternated(cfg, bs, generator, x.device, netF)
        bd_targets = create_targets_bd(y, cfg.attack_mode, cfg.target_label, cfg.num_classes)
        G.train()
        noise = G(x)

        with torch.no_grad():
            x_bd_c = trig(x, noise.detach(), sigma_draw=draws.sigma_c)
            poison = (y == bd_targets) & draws.poison
            x_mix = aug(torch.where(poison[:, None, None, None], x_bd_c, x), draws.aug_c)
        _c_step(stateC, C, x_mix, y)
        clean_preds = _clean_model_preds(full_metrics, clean_model, aug, x, draws.aug_cm)

        C.eval()
        x_bd = trig(x, noise, sigma_draw=draws.sigma_g)
        pred_bd = C(aug(x_bd, draws.aug_g))
        l_ce = cross_entropy(pred_bd, bd_targets)
        l_l2 = torch.mean((x_bd - x) ** 2)
        l_tv = total_variation(x_bd).mean()
        cm_bd = clean_model(aug(x_bd, draws.aug_g_cm))
        l_cm = cross_entropy(cm_bd, y)
        total = l_ce + cfg.L2_weight * l_l2 + cfg.tv_weight * l_tv + cfg.clean_model_weight * l_cm
        stateG.apply_gradients(torch.autograd.grad(total, list(G.parameters())))

        with torch.no_grad():
            x_bd = x_bd.detach()
            return {
                "sample": x.new_tensor(float(bs)),
                "loss_ce": l_ce.detach(),
                "loss_l2": l_l2.detach(),
                "loss_tv": l_tv.detach(),
                "loss_grad_l2": grad_l2_metric(x, x_bd),
                "clean_model_loss": l_cm.detach(),
                **_metric_counts(C, netF, aug, x, y, x_bd, draws.aug_clean, clean_preds, draws.drop_F),
                **_attack_counts(pred_bd, cm_bd, y, bd_targets),
            }

    return step


# --------------------------------------------------------------------------
# Multilabel (class-conditional generator)
# --------------------------------------------------------------------------


def multilabel_targets(bs: int, num_classes: int, device) -> torch.Tensor:
    """Row i's G-step target ``min(i // ceil(bs/K), K-1)``: the batch in
    contiguous chunks, one per class (reference
    ``train_generator_multilabel.py:203-224``)."""
    ps = (bs - 1) // num_classes + 1
    return torch.clamp(torch.arange(bs, device=device) // ps, max=num_classes - 1)


def make_multilabel_train_step(cfg: Config, C: nn.Module, G: nn.Module):
    """Its draws take the roles of :class:`AlternatedDraws`; the poison draw
    picks rows of any class, each triggered toward its own label."""
    refuse_train_dropout(C)
    aug = _aug_fn(cfg)
    trig = _trigger_fn(cfg)
    full_metrics = full_metrics_mode(cfg)

    def step(stateC, stateG, clean_model, netF, batch, generator=None,
             draws: Optional[AlternatedDraws] = None) -> Metrics:
        x, y = batch
        bs = x.shape[0]
        if draws is None:
            draws = draw_alternated(cfg, bs, generator, x.device, netF)
        G.train()

        with torch.no_grad():
            x_bd_c = trig(x, G(x, y), sigma_draw=draws.sigma_c)
            x_mix = aug(torch.where(draws.poison[:, None, None, None], x_bd_c, x), draws.aug_c)
        _c_step(stateC, C, x_mix, y)
        clean_preds = _clean_model_preds(full_metrics, clean_model, aug, x, draws.aug_cm)

        C.eval()
        bd_targets = multilabel_targets(bs, cfg.num_classes, x.device).to(y.dtype)
        x_bd = trig(x, G(x, bd_targets), sigma_draw=draws.sigma_g)
        pred_bd = C(aug(x_bd, draws.aug_g))
        l_ce = cross_entropy(pred_bd, bd_targets)
        l_l2 = torch.mean((x_bd - x) ** 2)
        cm_bd = clean_model(aug(x_bd, draws.aug_g_cm))
        l_cm = cross_entropy(cm_bd, y)
        total = l_ce + cfg.L2_weight * l_l2 + cfg.clean_model_weight * l_cm
        stateG.apply_gradients(torch.autograd.grad(total, list(G.parameters())))

        with torch.no_grad():
            return {
                "sample": x.new_tensor(float(bs)),
                "loss_ce": l_ce.detach(),
                "loss_l2": l_l2.detach(),
                "clean_model_loss": l_cm.detach(),
                **_metric_counts(C, netF, aug, x, y, x_bd.detach(), draws.aug_clean, clean_preds, draws.drop_F),
                **_attack_counts(pred_bd, cm_bd, y, bd_targets),
            }

    return step


def make_multilabel_eval_step(cfg: Config, C: nn.Module, G: nn.Module):
    """Every target class ci in turn, over the valid rows with y != ci
    (reference ``train_generator_multilabel.py:355-378``); the detector
    counts all valid rows each pass, as the reference does (``:378``).
    ``sigma_draws`` holds one blur sigma per class and ``drop_F`` the
    detector's masks per class (the JAX step's ``fold_in(key, ci)`` and
    ``fold_in(key, 1000 + ci)``), drawn in that order."""
    trig = _trigger_fn(cfg)

    @torch.no_grad()
    def step(clean_model, netF, batch, generator=None, sigma_draws: Optional[torch.Tensor] = None,
             drop_F: Optional[List[DetectorMasks]] = None) -> Metrics:
        x, y, valid = batch
        C.eval()
        G.eval()
        vf = valid.float()
        if sigma_draws is None:
            sigma_draws = torch.stack([draw_sigma(cfg.sigma, generator, x.device) for _ in range(cfg.num_classes)])
        if drop_F is None:
            drop_F = [draw_drop_F(netF, x.shape[0], generator, x.device) for _ in range(cfg.num_classes)]
        per_class = []
        for ci in range(cfg.num_classes):
            tmp = torch.full_like(y, ci)
            x_bd = trig(x, G(x, tmp), sigma_draw=sigma_draws[ci])
            cm_bd = clean_model(x_bd)
            nf = ((y != tmp) & valid).float()
            per_class.append({
                "bd_sample": nf.sum(),
                "bd_correct": _count(C(x_bd), tmp, nf),
                "clean_model_bd_ba": _count(cm_bd, y, nf),
                "clean_model_bd_asr": _count(cm_bd, tmp, nf),
                "F_correct": _count(detector_logits(netF, x_bd, drop_F[ci]), torch.ones_like(y), vf),
            })
        return {
            "clean_sample": vf.sum(),
            "clean_correct": _count(C(x), y, vf),
            "clean_model_correct": _count(clean_model(x), y, vf),
            **{k: torch.stack([m[k] for m in per_class]).sum() for k in per_class[0]},
        }

    return step


# --------------------------------------------------------------------------
# Victim variants
# --------------------------------------------------------------------------


def make_wanet_victim_train_step(cfg: Config, C: nn.Module, G: nn.Module):
    """Victim training with the warp trigger on the fixed poisoned subset
    (reference ``train_victim_wanet.py:58-135``); its one draw is the
    augmentation (the JAX step's ``k[0]``)."""
    refuse_train_dropout(C)
    aug = _aug_fn(cfg)

    def step(stateC: TrainState, batch, generator=None, draws: Optional[AugDraws] = None) -> Metrics:
        x, y, poisoned = batch
        if draws is None:
            draws = _draw_aug(cfg, x.shape[0], generator, x.device)
        bd_targets = create_targets_bd(y, cfg.attack_mode, cfg.target_label, cfg.num_classes)
        with torch.no_grad():
            G.eval()
            x_bd, _ = wanet_apply(x, G(x), cfg.grid_rescale)
            x_mix = aug(torch.where(poisoned[:, None, None, None], x_bd, x), draws)
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


def _victim_eval_metrics(cfg, C, x, y, valid, x_bd) -> Metrics:
    bd_targets = create_targets_bd(y, cfg.attack_mode, cfg.target_label, cfg.num_classes)
    vf, nf = valid.float(), ((y != cfg.target_label) & valid).float()
    return {
        "clean_sample": vf.sum(),
        "bd_sample": nf.sum(),
        "clean_correct": _count(C(x), y, vf),
        "bd_correct": _count(C(x_bd), bd_targets, nf),
    }


def make_wanet_victim_eval_step(cfg: Config, C: nn.Module, G: nn.Module):
    @torch.no_grad()
    def step(batch, generator=None) -> Metrics:
        x, y, valid = batch
        C.eval()
        G.eval()
        x_bd, _ = wanet_apply(x, G(x), cfg.grid_rescale)
        return _victim_eval_metrics(cfg, C, x, y, valid, x_bd)

    return step


def make_inputaware_victim_eval_step(cfg: Config, C: nn.Module, G: nn.Module):
    """The victim eval with cross accuracy from a second test stream
    (reference ``train_victim_inputaware.py:162-254``)."""
    trig = _trigger_fn(cfg)

    @torch.no_grad()
    def step(batch, generator=None, draws: Optional[PairSigmas] = None) -> Metrics:
        x, y, x2, valid = batch
        C.eval()
        G.eval()
        x_bd, x_bd2 = _pair_triggers(cfg, G, trig, x, x2, generator, draws)
        nf = ((y != cfg.target_label) & valid).float()
        return {**_victim_eval_metrics(cfg, C, x, y, valid, x_bd), "cross_correct": _count(C(x_bd2), y, nf)}

    return step
