"""WaNet victim (the port of ``combat_tpu/cli/train_victim_wanet.py``): the
fixed poisoned subset warped by the frozen GridGenerator of the generator
run; the checkpoint also stores ``grid_rescale`` (reference
``train_victim_wanet.py:58-135``, checkpoint ``:196-205``).

Example (synthetic data; on the card unless --device cpu), after
``train_generator_wanet --saving_prefix wanet``:
  python -m combat_tpu_torch.cli.train_victim_wanet --synthetic_data \
      --synthetic_size 1024 --n_iters 2 --saving_prefix vic_wanet --load_checkpoint wanet_clean
"""

from __future__ import annotations

from ..config import from_args
from ..train import make_wanet_victim_eval_step, make_wanet_victim_train_step
from ._victim import VictimSpec, run_victim

SPEC = VictimSpec(
    name="victim_wanet",
    generator_kind="grid",
    make_train_step=make_wanet_victim_train_step,
    make_eval_step=make_wanet_victim_eval_step,
    extra_ckpt=lambda cfg: {"grid_rescale": cfg.grid_rescale},
)


def run(cfg):
    return run_victim(cfg, SPEC)


def main(argv=None):
    return run(from_args(argv))


if __name__ == "__main__":
    main()
