"""Multilabel (class-conditional) variant (the port of
``combat_tpu/cli/train_generator_multilabel.py``): G(x, class) triggers
toward any class; the C-step poisons Bernoulli(pc) rows toward their own
labels; the G-step gives the rows their targets in contiguous chunks; eval
runs every target class (reference ``train_generator_multilabel.py:121-454``).

Example (synthetic data; on the card unless --device cpu), after
``train_clean_classifier --saving_prefix cleanrun``:
  python -m combat_tpu_torch.cli.train_generator_multilabel --synthetic_data \
      --synthetic_size 1024 --n_iters 2 --saving_prefix ml --load_checkpoint_clean cleanrun
"""

from __future__ import annotations

from ..config import from_args
from ..train import make_multilabel_eval_step, make_multilabel_train_step
from ._alternated import AlternatedSpec, run_alternated

SPEC = AlternatedSpec(
    name="multilabel",
    generator_kind="cunet",
    make_train_step=make_multilabel_train_step,
    make_eval_step=make_multilabel_eval_step,
    conditional=True,
)


def run(cfg):
    return run_alternated(cfg, SPEC)


def main(argv=None):
    return run(from_args(argv))


if __name__ == "__main__":
    main()
