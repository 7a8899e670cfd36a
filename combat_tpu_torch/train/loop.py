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

Every epoch draws from generators of its own, made by :func:`epoch_generator`
from ``(seed, stream, epoch)`` as the JAX package folds ``epoch`` (plus the
stream's offset) into the run's key: a run resumed at epoch e draws what the
run without a break drew at epoch e.

With a :class:`~combat_tpu_torch.train.mesh.World` of several ranks, every
rank builds the same generator for an epoch, draws the same permutation,
takes its block of rows of each full batch, of the ragged tail and of each
padded eval batch (``World.shard``), and passes the step that shard, so the
step draws at the global batch's size and keeps its rows; a rank runs
every step, on 0 rows too.  The epoch's metric sums are summed over the
ranks at its end.  At world size 1 (or ``world`` None) the steps are called
as in one process.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .mesh import Shard, World, all_reduce_sums, take_rows

Metrics = Dict[str, torch.Tensor]


# The streams of a run's per-epoch draws, each the offset the JAX package adds
# to the epoch before ``fold_in``: training, the frequency detector's eval,
# the attack runs' eval and the ``--image_every`` grid.
TRAIN_STREAM = 0
DETECTOR_EVAL_STREAM = 7_000_000
EVAL_STREAM = 10_000_000
GRID_STREAM = 20_000_000

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's step: a bijection of 64-bit words that spreads every
    input bit over the output."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def epoch_seed(seed: int, stream: int, epoch: int) -> int:
    """The 64-bit torch seed of ``stream``'s draws at ``epoch`` of a run
    seeded ``seed``: the three chained through :func:`_mix64`, so that no
    two triples meet as they would in a sum (seed 1 at epoch 1 and seed 2
    at epoch 0)."""
    return _mix64(_mix64(_mix64(seed & _MASK64) ^ stream) ^ epoch)


def epoch_generator(seed: int, stream: int, epoch: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with :func:`epoch_seed`; every rank
    of a run builds the same one for an epoch."""
    return torch.Generator(device=device).manual_seed(epoch_seed(seed, stream, epoch))


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


def _shard_of(world: Optional[World], n: int) -> Tuple[Optional[Shard], dict]:
    """This rank's shard of a global batch of n rows and the step's keyword
    for it; (None, {}) in one process, so the step is called as there."""
    shard = None if world is None else world.shard(n)
    return shard, ({} if shard is None else {"shard": shard})


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
    world: Optional[World] = None,
) -> Metrics:
    """One alternated-training epoch (reference train_generator.py train())."""
    full, tail = epoch_permutation(images.shape[0], bs, generator, images.device, perm)
    metrics = None
    for idx in (*full, tail):
        if idx.numel():
            shard, kw = _shard_of(world, idx.numel())
            idx = take_rows(idx, shard)
            m = step_fn(stateC, stateG, clean_model, netF, (gather_batch(images, idx), labels[idx]), generator, **kw)
            metrics = _accumulate(metrics, m)
    return all_reduce_sums(metrics, world)


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
    world: Optional[World] = None,
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
            shard, kw = _shard_of(world, idx.numel())
            idx, idx2 = take_rows(idx, shard), take_rows(idx2, shard)
            batch = (gather_batch(images, idx), labels[idx], gather_batch(images, idx2))
            m = step_fn(stateC, stateG, clean_model, netF, batch, generator, **kw)
            metrics = _accumulate(metrics, m)
    return all_reduce_sums(metrics, world)


def train_epoch_classifier(
    step_fn: Callable,
    stateC,
    images: torch.Tensor,
    labels: torch.Tensor,
    generator: Optional[torch.Generator],
    bs: int,
    perm: Optional[torch.Tensor] = None,
    poisoned: Optional[torch.Tensor] = None,
    world: Optional[World] = None,
) -> Metrics:
    """One classifier-only epoch: clean training, or victim training when
    the fixed (N,) poison mask ``poisoned`` is given, whose rows then reach
    the step with the batch as ``(images, labels, poisoned)``."""
    full, tail = epoch_permutation(images.shape[0], bs, generator, images.device, perm)
    metrics = None
    for idx in (*full, tail):
        if idx.numel():
            shard, kw = _shard_of(world, idx.numel())
            idx = take_rows(idx, shard)
            x = gather_batch(images, idx)
            batch = (x, labels[idx]) if poisoned is None else (x, labels[idx], poisoned[idx])
            metrics = _accumulate(metrics, step_fn(stateC, batch, generator, **kw))
    return all_reduce_sums(metrics, world)


def eval_epoch(
    step_fn: Callable,
    step_args: Tuple,
    images: torch.Tensor,
    labels: torch.Tensor,
    bs: int,
    with_pair: bool = False,
    pair_perm: Optional[torch.Tensor] = None,
    world: Optional[World] = None,
    **step_kw,
) -> Metrics:
    """Run an eval step over padded whole batches; exact masked sums.
    ``with_pair`` adds a second, shuffled image stream, ``images[pair_perm[ix]]``
    beside each batch (the input-aware cross accuracy); the permutation is
    drawn from ``step_kw``'s ``generator`` unless passed in.  Each rank of
    ``world`` takes its rows of every padded batch with their mask."""
    n = images.shape[0]
    idx, valid = padded_eval_batches(n, bs, images.device)
    if with_pair and pair_perm is None:
        pair_perm = torch.randperm(n, generator=step_kw.get("generator"), device=images.device)
    metrics = None
    for ix, vd in zip(idx, valid):
        shard, kw = _shard_of(world, ix.numel())
        ix, vd = take_rows(ix, shard), take_rows(vd, shard)
        x = gather_batch(images, ix)
        batch = (x, labels[ix], gather_batch(images, pair_perm[ix]), vd) if with_pair else (x, labels[ix], vd)
        metrics = _accumulate(metrics, step_fn(*step_args, batch, **step_kw, **kw))
    return all_reduce_sums(metrics, world)


def metrics_to_host(metrics: Metrics) -> Dict[str, float]:
    keys = list(metrics)
    values = torch.stack([metrics[k].float() for k in keys]).tolist()
    return dict(zip(keys, values))
