"""Epoch runners (the port of ``combat_tpu/train/loop.py``).

The split lives on the device as one NCHW tensor, float32 or, for a split
above 1 GiB, uint8 (``cli/common.py::device_dataset``), so a minibatch is a
device-side gather followed by :func:`dequantize` (:func:`gather_batch`).
Every training epoch covers all N rows, like the reference's
``DataLoader(drop_last=False)``: one permutation per epoch, the full
batches, then the ragged tail (n % bs rows) as one extra step at its true
shape, so BatchNorm, the loss and the metrics see the genuine small
batch.  Eval pads to whole batches with a validity mask, so eval metrics are
exact.  Metrics stay on the device, summed, until the epoch's end.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Metrics = Dict[str, torch.Tensor]


def dequantize(x: torch.Tensor) -> torch.Tensor:
    """A uint8 batch back to the [-1, 1] float32 range, ``u8 / 127.5 - 1``
    as the JAX package computes it (the reference's ToTensor and
    Normalize(0.5, 0.5) of a uint8 frame); a float batch passes through."""
    if x.dtype == torch.uint8:
        return x.float() / 127.5 - 1.0
    return x


def gather_batch(images: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of the device-resident split, dequantized."""
    return dequantize(images[idx])


def epoch_permutation(
    n: int, bs: int, generator: Optional[torch.Generator], device, perm: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(full_batches, tail): an (n//bs, bs) index matrix and the ragged
    remainder of length n % bs (possibly 0).  ``perm`` may be passed in."""
    if perm is None:
        perm = torch.randperm(n, generator=generator, device=device)
    steps = n // bs
    return perm[: steps * bs].view(steps, bs), perm[steps * bs :]


def padded_eval_batches(n: int, bs: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index and validity-mask matrices covering all n rows in whole batches."""
    steps = (n + bs - 1) // bs
    idx = torch.arange(steps * bs, device=device)
    valid = idx < n
    return idx.clamp(max=n - 1).view(steps, bs), valid.view(steps, bs)


def _accumulate(total: Optional[Metrics], m: Metrics) -> Metrics:
    if total is None:
        return dict(m)
    return {k: total[k] + v for k, v in m.items()}


def train_epoch_alternated(
    step_fn: Callable,
    stateC,
    stateG,
    clean_model,
    netF,
    images: torch.Tensor,
    labels: torch.Tensor,
    generator: Optional[torch.Generator],
    bs: int,
    perm: Optional[torch.Tensor] = None,
) -> Metrics:
    """One alternated-training epoch (reference train_generator.py train())."""
    full, tail = epoch_permutation(images.shape[0], bs, generator, images.device, perm)
    metrics = None
    for idx in (*full, tail):
        if idx.numel():
            m = step_fn(stateC, stateG, clean_model, netF, (gather_batch(images, idx), labels[idx]), generator)
            metrics = _accumulate(metrics, m)
    return metrics


def train_epoch_alternated_pair(
    step_fn: Callable,
    stateC,
    stateG,
    clean_model,
    netF,
    images: torch.Tensor,
    labels: torch.Tensor,
    generator: Optional[torch.Generator],
    bs: int,
    perm: Optional[torch.Tensor] = None,
    perm2: Optional[torch.Tensor] = None,
) -> Metrics:
    """An alternated epoch with a second, independent shuffle of the split
    (the input-aware variant's two dataloaders, reference
    ``train_generator_inputaware.py:535-538``): each batch reaches the step
    as ``(x, y, x2)``, the ragged tail too.  Either permutation may be
    passed in."""
    n, device = images.shape[0], images.device
    full, tail = epoch_permutation(n, bs, generator, device, perm)
    full2, tail2 = epoch_permutation(n, bs, generator, device, perm2)
    metrics = None
    for idx, idx2 in zip((*full, tail), (*full2, tail2)):
        if idx.numel():
            batch = (gather_batch(images, idx), labels[idx], gather_batch(images, idx2))
            m = step_fn(stateC, stateG, clean_model, netF, batch, generator)
            metrics = _accumulate(metrics, m)
    return metrics


def train_epoch_classifier(
    step_fn: Callable,
    stateC,
    images: torch.Tensor,
    labels: torch.Tensor,
    generator: Optional[torch.Generator],
    bs: int,
    perm: Optional[torch.Tensor] = None,
    poisoned: Optional[torch.Tensor] = None,
) -> Metrics:
    """One classifier-only epoch: clean training, or victim training when
    the fixed (N,) poison mask ``poisoned`` is given, whose rows then reach
    the step with the batch as ``(images, labels, poisoned)``."""
    full, tail = epoch_permutation(images.shape[0], bs, generator, images.device, perm)
    metrics = None
    for idx in (*full, tail):
        if idx.numel():
            x = gather_batch(images, idx)
            batch = (x, labels[idx]) if poisoned is None else (x, labels[idx], poisoned[idx])
            metrics = _accumulate(metrics, step_fn(stateC, batch, generator))
    return metrics


def eval_epoch(
    step_fn: Callable,
    step_args: Tuple,
    images: torch.Tensor,
    labels: torch.Tensor,
    bs: int,
    with_pair: bool = False,
    pair_perm: Optional[torch.Tensor] = None,
    **step_kw,
) -> Metrics:
    """Run an eval step over padded whole batches; exact masked sums.
    ``with_pair`` adds a second, shuffled image stream, ``images[pair_perm[ix]]``
    beside each batch (the input-aware cross accuracy); the permutation is
    drawn from ``step_kw``'s ``generator`` unless passed in."""
    n = images.shape[0]
    idx, valid = padded_eval_batches(n, bs, images.device)
    if with_pair and pair_perm is None:
        pair_perm = torch.randperm(n, generator=step_kw.get("generator"), device=images.device)
    metrics = None
    for ix, vd in zip(idx, valid):
        x = gather_batch(images, ix)
        batch = (x, labels[ix], gather_batch(images, pair_perm[ix]), vd) if with_pair else (x, labels[ix], vd)
        metrics = _accumulate(metrics, step_fn(*step_args, batch, **step_kw))
    return metrics


def metrics_to_host(metrics: Metrics) -> Dict[str, float]:
    keys = list(metrics)
    values = torch.stack([metrics[k].float() for k in keys]).tolist()
    return dict(zip(keys, values))
