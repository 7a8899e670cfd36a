"""The conditioning of ``chip_smoke.py`` phase 6-tz's steps on the card: the
yardsticks beside the grid's gap to one process.

1. How far one float32 rounding of the input images moves each run's
   one-process step: every run of ``chip_smoke.TZ_RUNS`` takes its step alone
   three times from the same weights, as 6-tz does, again, and with every
   input pixel moved by one float32 spacing up or down (a seeded sign); it
   prints ``||a - b|| / ||b - initial||`` of C and G for the second and the
   third against the first.
2. ShuffleNetG2's grid with cuDNN on (``shufflenetg2_cudnn``, which 6-tz
   does not hold): the four gloo ranks against one process, as 6-tz prints
   its runs.
3. The same grid and step in float64 with cuDNN on (``shufflenetg2_cudnn_f64``:
   the weights and images of 2 in float64, the trigger on its ATen route,
   since K1/K2 take float32 only): if the float32 gap of 2 is the step's
   conditioning, it falls here to float64's roundings; a form that cuDNN
   computes wrongly on the grid keeps it.

    python scripts/tz_conditioning.py      # on a machine with a card, from the repo root
    python scripts/tz_conditioning.py f64  # part 3 alone
"""

import os
import sys
import tempfile

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402

# Part 3's run, set up here at import, so the spawned ranks (which import
# this file again) see it too.
F64_RUN = "shufflenetg2_cudnn_f64"
cs.TZ_RUNS[F64_RUN] = cs.TZ_RUNS["shufflenetg2_cudnn"]
_tz_cfg, _tz_step, _tz_setup = cs._tz_cfg, cs._tz_step, cs._tz_setup


def _f64_cfg(run: str):
    cfg = _tz_cfg(run)
    return cfg.replace(pallas_trigger=False, pallas_lowfreq=False) if run == F64_RUN else cfg


def _f64_step(setup: str, run: str, world) -> dict:
    import torch

    if run != F64_RUN:
        return _tz_step(setup, run, world)
    torch.set_default_dtype(torch.float64)
    try:
        return _tz_step(setup, run, world)
    finally:
        torch.set_default_dtype(torch.float32)


def _f64_setup(workdir, runs) -> str:
    """The setup of :func:`chip_smoke._tz_setup`, its images in float64 when
    part 3's run is among ``runs``."""
    import torch

    path = _tz_setup(workdir, runs)
    if F64_RUN in runs:
        saved = torch.load(path, weights_only=True)
        saved["data"]["images"] = saved["data"]["images"].double()
        torch.save(saved, path)
    return path


cs._tz_cfg, cs._tz_step, cs._tz_setup = _f64_cfg, _f64_step, _f64_setup


def part3() -> None:
    cs.TZ_STEP = (0, 0, 0)  # part 3's trigger runs on ATen: no kernel launches
    cs.registry_grids_on_one_card(cs.start_registry_grids((F64_RUN,)))

if __name__ == "__main__":
    import torch

    from combat_tpu_torch.ops import trigger_kernels as tk

    if not torch.cuda.is_available():
        raise SystemExit("tz_conditioning: torch sees no CUDA device")
    tk.build()
    cs._float32_as_the_entry_points()
    print(torch.cuda.get_device_name(0), flush=True)
    if sys.argv[1:] == ["f64"]:
        part3()
        raise SystemExit(0)
    with tempfile.TemporaryDirectory() as folder:
        runs = [r for r in cs.TZ_RUNS if r != F64_RUN]
        setup = cs._tz_setup(folder, runs)
        saved = torch.load(setup, weights_only=True)
        x = saved["data"]["images"]
        sign = torch.where(torch.rand(x.shape, generator=torch.Generator().manual_seed(3)) < 0.5, -1.0, 1.0)
        saved["data"]["images"] = x + sign * x.abs() * 2.0**-23  # one float32 spacing, either way
        perturbed = f"{folder}/perturbed.pt"
        torch.save(saved, perturbed)
        keep = lambda k: "running_" not in k and "num_batches" not in k  # noqa: E731
        for run in runs:
            init = saved["models"][cs._tz_weights(run)]
            one, again, moved = (cs._tz_step(s, run, None) for s in (setup, setup, perturbed))
            for part in ("C", "G"):
                print(f"{run} {part}: same input again {cs._update_ratio(again[part], one[part], init[part], keep):.3e}, "
                      f"one-ulp input {cs._update_ratio(moved[part], one[part], init[part], keep):.3e}", flush=True)
    cs.registry_grids_on_one_card(cs.start_registry_grids(("shufflenetg2_cudnn",)))
    part3()
