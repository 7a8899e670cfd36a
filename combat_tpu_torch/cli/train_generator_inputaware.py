"""Input-aware variant (the port of
``combat_tpu/cli/train_generator_inputaware.py``): a second, independent
shuffle of the split feeds a cross-trigger loss ``cross_weight * CE(C(x +
trigger(G(x2))), y)`` that forces the trigger to be input-specific; cross
accuracy is tracked in training and eval (reference
``train_generator_inputaware.py:141-508``).  G's lr is lr_C * 0.1 on C's
milestones (``:120-127``); the checkpoint also stores the reference's
vestigial ``mask`` (0.1 on rows and columns 2-5) and random ``pattern``,
and ``best_cross_acc``.

Example (synthetic data; on the card unless --device cpu), after
``train_clean_classifier --saving_prefix cleanrun``:
  python -m combat_tpu_torch.cli.train_generator_inputaware --synthetic_data \
      --synthetic_size 1024 --n_iters 2 --saving_prefix ia --load_checkpoint_clean cleanrun
"""

from __future__ import annotations

import torch

from ..config import Config, from_args
from ..train import make_inputaware_eval_step, make_inputaware_train_step
from ._alternated import AlternatedSpec, run_alternated


def mask_pattern(cfg: Config):
    """The reference's ``mask`` (H, W), zeros with 0.1 on ``[2:6, 2:6]``, and
    a U(0, 1) ``pattern`` (C, H, W) drawn from the run's seed
    (``train_generator_inputaware.py:616-618``)."""
    mask = torch.zeros((cfg.input_height, cfg.input_width))
    mask[2:6, 2:6] = 0.1
    gen = torch.Generator().manual_seed(cfg.seed)
    pattern = torch.rand((cfg.input_channel, cfg.input_height, cfg.input_width), generator=gen)
    return {"mask": mask, "pattern": pattern}


SPEC = AlternatedSpec(
    name="inputaware",
    make_train_step=make_inputaware_train_step,
    make_eval_step=make_inputaware_eval_step,
    pair=True,
    g_lr_from_c=True,
    track_cross=True,
    extra_ckpt=mask_pattern,
)


def run(cfg):
    return run_alternated(cfg, SPEC)


def main(argv=None):
    return run(from_args(argv))


if __name__ == "__main__":
    main()
