"""Multilabel victim (the port of
``combat_tpu/cli/train_victim_multilabel.py``): it continues alternated G+C
training from the generator run named by ``--load_checkpoint``, with the
clean model of ``--load_checkpoint_clean`` and the frequency detector, as
the reference script does (``train_victim_multilabel.py:121-305,495-520``).

Example (synthetic data; on the card unless --device cpu), after the runs
of ``train_generator_multilabel``'s example:
  python -m combat_tpu_torch.cli.train_victim_multilabel --synthetic_data \
      --synthetic_size 1024 --n_iters 2 --saving_prefix vic_ml \
      --load_checkpoint ml_clean --load_checkpoint_clean cleanrun
"""

from __future__ import annotations

from ..config import from_args
from ..train import make_multilabel_eval_step, make_multilabel_train_step
from ._alternated import AlternatedSpec, run_alternated

SPEC = AlternatedSpec(
    name="victim_multilabel",
    generator_kind="cunet",
    make_train_step=make_multilabel_train_step,
    make_eval_step=make_multilabel_eval_step,
    conditional=True,
    load_g=True,
)


def run(cfg):
    return run_alternated(cfg, SPEC)


def main(argv=None):
    return run(from_args(argv))


if __name__ == "__main__":
    main()
