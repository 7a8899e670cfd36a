"""How far one full-width alternated step (bs 16 or ``--bs``, cifar10, UNet nf 64, the
dropout-ensemble detector) moves the updated parameters when its input moves
by Gaussian noise of a given size, on the CPU in float32, for each classifier
named (the surrogate C and the clean model).

``chip_smoke.py``'s phase 6 holds the card's step to the CPU's at 1e-4 on the
parameters; a classifier whose step moves a parameter by more than that under
an input noise of 1e-6 (the size of the trigger kernels' differences from
their plain versions) cannot be held so.  Prints one line a classifier and
noise: the largest parameter difference and its tensor.

    python scripts/step_conditioning.py mobilenetv2 densenet121 preactresnet18
"""

from __future__ import annotations

import argparse
import copy
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from combat_tpu_torch.config import Config, apply_dataset_preset  # noqa: E402
from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator  # noqa: E402
from combat_tpu_torch.train import TrainState, draw_alternated, freeze, make_alternated_train_step  # noqa: E402
from combat_tpu_torch.train import multistep_lr  # noqa: E402


def step_state(model: str, noise: float, seed: int = 11, bs: int = 16):
    """C's and G's state dicts after one step on the seeded batch plus
    ``noise`` times a fixed Gaussian draw."""
    cfg = apply_dataset_preset(Config(device="cpu", model=model, F_model="original_dropout_ensemble"))
    torch.manual_seed(seed)
    weights = [get_classifier(cfg), get_generator(cfg), get_classifier(cfg), get_frequency_detector(cfg)]
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.rand((bs, 3, 32, 32), generator=gen) * 2 - 1
    y = torch.arange(bs) % 4
    draws = draw_alternated(cfg, bs, gen, "cpu", freeze(copy.deepcopy(weights[3])))
    x = x + noise * torch.randn(x.shape, generator=torch.Generator().manual_seed(99))
    C, G, cm, nf = (copy.deepcopy(m) for m in weights)
    sched = multistep_lr(0.01, (100,), 0.1, 10)
    make_alternated_train_step(cfg, C, G)(TrainState(C, sched), TrainState(G, sched), freeze(cm), freeze(nf),
                                          (x, y), draws=draws)
    return {**{f"C.{k}": v for k, v in C.state_dict().items()}, **{f"G.{k}": v for k, v in G.state_dict().items()}}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("models", nargs="+")
    parser.add_argument("--noise", type=float, nargs="+", default=[1e-6, 1e-5])
    parser.add_argument("--bs", type=int, default=16)
    args = parser.parse_args(argv)
    for model in args.models:
        base = step_state(model, 0.0, bs=args.bs)
        for noise in args.noise:
            moved = step_state(model, noise, bs=args.bs)
            worst, name = max((float((moved[k] - v).abs().max()), k) for k, v in base.items() if v.is_floating_point())
            print(f"{model} (bs {args.bs}): input noise {noise:g} moves {name} by {worst:.3e}", flush=True)


if __name__ == "__main__":
    main()
