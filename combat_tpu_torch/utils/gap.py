"""The gap criterion: how a low-precision (``--compute_dtype``) run is held
to a reference.

bfloat16 keeps 8 bits of mantissa, so two implementations of one
mixed-precision recipe, each rounding at the same points in another order,
agree only to about the rounding itself; element-wise maxima are no
yardstick.  For each compared tensor let ``gap = rms(ref_low - ref_f32)``:
how far the reference's low-precision run lands from its float32 run on the
same weights, inputs and draws, floored at ``FLOOR_ULPS`` float32 units of
the float32 run's values (a conv bias before InstanceNorm moves by weight
decay and rounding errors alone, and its gap can fall below one unit).
Then

  (a) ``rms(low - ref_f32) <= ALPHA * gap``: as close to float32 as the
      reference's low-precision run;
  (b) ``rms(low - ref_low) <= BETA * gap``: two independent roundings at
      the same points differ by about sqrt(2) gap;
  (c) ``rms(low - low_f32) >= GAMMA * gap``: low precision really ran.

The CPU tests (``tests/test_torch_bf16_*.py``) take the JAX package's two
runs as the reference; ``chip_smoke.py`` takes the CPU's bfloat16 run and
the card's float32 run (so there ``low_f32`` is ``ref_f32`` and (a) is (c)).

A step is held so (:func:`step_failures`):

* each parameter or statistic of at least ``MIN_NUMEL`` numbers by (a) and
  (b); each model's tensors together by (a) and (b); all of them together
  by (a), (b) and (c).  The rms of a few numbers is one to a few draws of
  the rounding, and the ratio of two such draws has no useful bound: the
  UNet's 3-number output bias, card against CPU, read (b) 0.34-1.88 over
  six seeds and 5.8 in one other run.  (c) on one tensor or one model is
  noise where its update is mostly weight decay.
* where the reference's two runs leave a tensor identical (a conv bias
  before InstanceNorm has no gradient, so weight decay alone moves it),
  ``low`` is held to them at the caller's float32 tolerance.
* the losses, as one vector of every draw the caller has (the losses of
  one step, or of several seeds' steps), by (b) alone.  A loss is one
  float32 mean, so its gap is a single draw of the rounding noise; (a) and
  (c) on a few of them compare two such draws.
* the counts within ``COUNT_ALLOWANCE`` rows: a near-tie of two bfloat16
  logits can land on either side under two roundings.

The constants come from the ratios the CPU tests measure (the models'
outputs (a) <= 1.12, (b) <= 1.17, (c) >= 0.75; single tensors after a step
(a) <= 1.49, (b) <= 2.05; all of a step's tensors (a) <= 1.17, (b) <= 1.14,
(c) >= 1.04; the losses (b) <= 1.46).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

ALPHA, BETA, GAMMA = 2.0, 3.0, 0.5
MIN_NUMEL = 64
FLOOR_ULPS = 4
COUNT_ALLOWANCE = 2


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64).reshape(-1)


def rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(_f64(a)))))


def floored_gap(ref_low, ref_f32) -> float:
    ref_f32 = _f64(ref_f32)
    floor = FLOOR_ULPS * rms(np.spacing(np.abs(ref_f32).astype(np.float32)))
    return max(rms(_f64(ref_low) - ref_f32), floor)


def ratios(low, low_f32, ref_low, ref_f32):
    """(gap, a, b, c) of the criterion, for arrays of one layout."""
    low, low_f32, ref_low, ref_f32 = (_f64(t) for t in (low, low_f32, ref_low, ref_f32))
    gap = floored_gap(ref_low, ref_f32)
    return gap, rms(low - ref_f32) / gap, rms(low - ref_low) / gap, rms(low - low_f32) / gap


def gap_failure(what: str, low, low_f32, ref_low, ref_f32, checks: str = "abc", f32_tol: float = 5e-5):
    """None, or why ``low`` misses the criterion's ``checks`` (a subset of
    "abc").  Where the reference's runs are identical and (c) is not asked,
    ``low`` is held to them at ``f32_tol``."""
    low, ref_low, ref_f32 = _f64(low), _f64(ref_low), _f64(ref_f32)
    if rms(ref_low - ref_f32) == 0.0:
        if "c" in checks:
            return f"{what}: the reference's low-precision run equals its float32 run"
        far = float(np.max(np.abs(low - ref_low), initial=0.0))
        return None if far <= f32_tol else f"{what}: {far:.3e} from the reference, whose runs agree (> {f32_tol})"
    gap, a, b, c = ratios(low, low_f32, ref_low, ref_f32)
    ok = {"a": a <= ALPHA, "b": b <= BETA, "c": c >= GAMMA}
    if all(ok[k] for k in checks):
        return None
    return f"{what}: gap {gap:.3e}; a {a:.2f} (<= {ALPHA}), b {b:.2f} (<= {BETA}), c {c:.2f} (>= {GAMMA})"


def loss_ratio(low, ref_low, ref_f32):
    """(gap, b) of a vector of losses."""
    gap = floored_gap(ref_low, ref_f32)
    return gap, rms(_f64(low) - _f64(ref_low)) / gap


def loss_failure(what: str, low, ref_low, ref_f32):
    gap, b = loss_ratio(low, ref_low, ref_f32)
    return None if b <= BETA else f"{what}: gap {gap:.3e}; b {b:.2f} (<= {BETA})"


def count_failures(what: str, low: dict, ref_low: dict, keys: Sequence[str]) -> list:
    return [f"{what}: count {k} {low[k]} against {ref_low[k]}" for k in keys
            if not abs(float(low[k]) - float(ref_low[k])) <= COUNT_ALLOWANCE]


def state_failures(models, f32_tol: float = 5e-5) -> list:
    """``models``: (name, low, low_f32, ref_low, ref_f32) state dicts of
    tensors, the reference's keyed as the port's.  Every floating tensor of
    ``ref_low`` is held as the module docstring says; ``low``'s must be
    float32."""
    failures, together = [], [[], [], [], []]
    for name, low, low_f32, ref_low, ref_f32 in models:
        keys = [k for k in ref_low if ref_low[k].is_floating_point()]
        failures += [f"{name} {k} is {low[k].dtype}" for k in keys if low[k].dtype != torch.float32]
        model = [[_f64(sd[k]) for k in keys] for sd in (low, low_f32, ref_low, ref_f32)]
        for k, *arrays in zip(keys, *model):
            if arrays[0].size >= MIN_NUMEL:
                failures.append(gap_failure(f"{name} {k}", *arrays, checks="ab", f32_tol=f32_tol))
        failures.append(gap_failure(f"{name}, every tensor", *(np.concatenate(m) for m in model), checks="ab",
                                    f32_tol=f32_tol))
        for t, m in zip(together, model):
            t.extend(m)
    failures.append(gap_failure("every tensor", *(np.concatenate(t) for t in together)))
    return [f for f in failures if f]


def step_failures(what: str, low: dict, ref_low: dict, ref_f32: dict, losses: Sequence[str], models,
                  f32_tol: float = 5e-5) -> list:
    """One step's metrics (``losses``; every other metric a count) and
    ``models`` (as :func:`state_failures` takes them)."""
    failures = count_failures(what, low, ref_low, [k for k in ref_low if k not in losses])
    failure = loss_failure(f"{what} losses {list(losses)}", *([float(m[k]) for k in losses]
                                                               for m in (low, ref_low, ref_f32)))
    return failures + ([failure] if failure else []) + [f"{what} {f}" for f in state_failures(models, f32_tol)]
