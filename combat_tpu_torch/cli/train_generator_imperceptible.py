"""Imperceptible variant (the port of
``combat_tpu/cli/train_generator_imperceptible.py``): the base alternated
training with ``tv_weight * total_variation(x_bd).mean()`` added to G's loss
(reference ``train_generator_imperceptible.py:114-312``); its backward runs
through the trigger's kernel K2.

Example (synthetic data; on the card unless --device cpu), after
``train_clean_classifier --saving_prefix cleanrun``:
  python -m combat_tpu_torch.cli.train_generator_imperceptible --synthetic_data \
      --synthetic_size 1024 --n_iters 2 --saving_prefix imp --load_checkpoint_clean cleanrun
"""

from __future__ import annotations

from ..config import from_args
from ..train import make_attack_eval_step, make_imperceptible_train_step
from ._alternated import AlternatedSpec, run_alternated

SPEC = AlternatedSpec(
    name="imperceptible",
    make_train_step=make_imperceptible_train_step,
    make_eval_step=make_attack_eval_step,
)


def run(cfg):
    return run_alternated(cfg, SPEC)


def main(argv=None):
    return run(from_args(argv))


if __name__ == "__main__":
    main()
