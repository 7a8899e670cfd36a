"""Alternated training of the trigger generator G + surrogate classifier C
(the port of ``combat_tpu/cli/train_generator.py``).

Per batch: a C-step on Bernoulli(pc)-poisoned target-class rows with clean
labels, then a G-step minimizing ``CE(C(aug(x_bd)), target) +
L2_weight*MSE + clean_model_weight*CE(cleanModel(aug(x_bd)), y)`` against a
frozen clean model, with frequency-detector evasion tracked as a metric;
then the attack eval over non-target test rows, the lexicographic (clean
acc, bd acc) best gate and the reference's checkpoint keys.

Example (synthetic data; on the card unless --device cpu):
  python -m combat_tpu_torch.cli.train_clean_classifier --synthetic_data \
      --synthetic_size 1024 --n_iters 2 --saving_prefix cleanrun
  python -m combat_tpu_torch.cli.train_generator --synthetic_data \
      --synthetic_size 1024 --n_iters 2 --saving_prefix atk --load_checkpoint_clean cleanrun
"""

from __future__ import annotations

from ..config import from_args
from ._alternated import AlternatedSpec, run_alternated

SPEC = AlternatedSpec(name="attack")


def run(cfg):
    return run_alternated(cfg, SPEC)


def main(argv=None):
    return run(from_args(argv))


if __name__ == "__main__":
    main()
