"""Input-aware victim (the port of
``combat_tpu/cli/train_victim_inputaware.py``): the base victim training,
and an eval that adds the cross-trigger accuracy against a second shuffled
test stream (reference ``train_victim_inputaware.py:88-254``).

Example (synthetic data; on the card unless --device cpu), after
``train_generator_inputaware --saving_prefix ia``:
  python -m combat_tpu_torch.cli.train_victim_inputaware --synthetic_data \
      --synthetic_size 1024 --n_iters 2 --saving_prefix vic_ia --load_checkpoint ia_clean
"""

from __future__ import annotations

from ..config import from_args
from ..train import make_inputaware_victim_eval_step
from ._victim import VictimSpec, run_victim

SPEC = VictimSpec(
    name="victim_inputaware",
    make_eval_step=make_inputaware_victim_eval_step,
    eval_pair=True,
    track_cross=True,
)


def run(cfg):
    return run_victim(cfg, SPEC)


def main(argv=None):
    return run(from_args(argv))


if __name__ == "__main__":
    main()
