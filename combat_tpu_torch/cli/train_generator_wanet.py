"""WaNet-variant alternated training (the port of
``combat_tpu/cli/train_generator_wanet.py``): G is a GridGenerator producing
a (B, 2, s, s) flow field; the trigger grid-samples the image through
``clamp(identity*(1-grid_rescale) + bicubic_upsample(flow)*grid_rescale)``,
and G's L2 term is ``MSE(flow_up, 0)`` (reference
``train_generator_wanet.py:95-305``).  It launches no trigger kernel.

Example (synthetic data; on the card unless --device cpu), after
``train_clean_classifier --saving_prefix cleanrun``:
  python -m combat_tpu_torch.cli.train_generator_wanet --synthetic_data \
      --synthetic_size 1024 --n_iters 2 --saving_prefix wanet --load_checkpoint_clean cleanrun
"""

from __future__ import annotations

from ..config import from_args
from ..train import make_wanet_eval_step, make_wanet_train_step
from ._alternated import AlternatedSpec, run_alternated

SPEC = AlternatedSpec(
    name="wanet",
    generator_kind="grid",
    make_train_step=make_wanet_train_step,
    make_eval_step=make_wanet_eval_step,
)


def run(cfg):
    return run_alternated(cfg, SPEC)


def main(argv=None):
    return run(from_args(argv))


if __name__ == "__main__":
    main()
