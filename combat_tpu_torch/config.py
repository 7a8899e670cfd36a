"""Typed configuration for the PyTorch port.

The port's own copy of ``combat_tpu/config.py``: the same ``Config`` fields,
dataset presets and CLI flags, so a command line written for the JAX package
parses here unchanged.  What differs:

  * ``device`` defaults to ``"cuda"`` and is honoured: every entry point runs
    on ``cuda:0`` unless ``--device cpu`` is passed.  Nothing falls back.
  * ``pallas_trigger`` defaults to true, so the card's main path runs the
    fused trigger kernels (K1/K2, ``ops/trigger_kernels.py``).  With
    ``--pallas_trigger false`` the low-pass runs on its own, then clamp and
    blur: as kernel K3 with ``--pallas_lowfreq true``, else (the default, as
    in the JAX package) as the ATen chain.  Every route takes any H: the
    kernels hold a plane per block up to 64 px and run tiled above.
  * boolean flags take an optional value (``--flag``, ``--flag true``,
    ``--flag false``), so a default of true can be turned off.
  * ``scan_chunk`` and ``remat`` are accepted and are no-ops: epochs are
    Python loops with no dispatch to chunk, and PyTorch keeps activations.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class Config:
    # --- paths / run management ---
    data_root: str = "./data"
    checkpoints: str = "./checkpoints"
    temps: str = "./temps"
    device: str = "cuda"  # "cuda" (default) or "cpu"; no fallback between them
    continue_training: bool = False
    saving_prefix: Optional[str] = None
    attack_mode: str = "all2one"
    load_checkpoint: str = ""
    load_checkpoint_clean: Optional[str] = None

    # --- dataset geometry ---
    dataset: str = "cifar10"
    input_height: int = 32
    input_width: int = 32
    input_channel: int = 3
    num_classes: int = 10

    # --- optimization ---
    bs: int = 128
    lr_C: float = 1e-2
    lr_G: float = 1e-2
    lr_clean: float = 1e-2
    schedulerC_milestones: Tuple[int, ...] = (100, 150)
    schedulerG_milestones: Tuple[int, ...] = (100, 150)
    scheduler_clean_milestones: Tuple[int, ...] = (100, 150)
    schedulerC_lambda: float = 0.1
    schedulerG_lambda: float = 0.1
    scheduler_clean_lambda: float = 0.1
    n_iters: int = 200
    num_workers: int = 6  # unused: the split lives on the device
    lambda_cov: float = 1.0  # vestigial in the reference

    # --- attack knobs ---
    noise_rate: float = 0.08
    target_label: int = 0
    pc: float = 0.5
    cross_rate: float = 1.0  # vestigial in the reference
    s: int = 2
    grid_rescale: float = 0.15
    ratio: float = 0.65  # DCT low-pass cutoff fraction
    kernel_size: int = 3  # Gaussian blur kernel
    sigma: Tuple[float, float] = (0.1, 1.0)  # Gaussian blur sigma range

    # --- augmentation ---
    random_rotation: int = 10
    random_crop: int = 5

    # --- WaNet / grid extras (vestigial in the reference) ---
    scale: float = 1.0
    S2: int = 8
    clamp: bool = False
    nearest: float = 0.0
    lnoise: int = 8

    # --- model / loss selection ---
    model: str = "default"
    tv_weight: float = 0.01
    L2_weight: float = 0.02
    F_checkpoints: str = "./defenses/frequency_based/checkpoints"
    F_model: str = "original"
    F_dropout: float = 0.5
    F_num_ensemble: int = 3
    model_clean: str = "default"
    clean_model_weight: float = 0.8
    noise_only: bool = False  # vestigial in the reference
    post_transform_option: str = "use"  # use | no_use | use_modified
    scale_noise_rate: float = 1.0  # vestigial in the reference
    cross_weight: float = 0.2

    # --- misc (vestigial in the reference) ---
    debug: bool = False
    r: float = 0.25
    scale_factor: float = 0.5
    scale_mode: str = "bicubic"

    # --- additions of the JAX package, kept for flag parity ---
    seed: int = 0
    dp_axis: str = "data"  # single device only in this port so far
    n_devices: int = 0  # 0 or 1; more devices raise (data parallelism is later work)
    multihost: bool = False  # raises when set (later work)
    coordinator_address: str = ""
    process_id: int = -1
    num_processes: int = -1
    # float32 (or f32, ""), bfloat16 or float16: the convolutions and linears
    # compute in it, parameters, norms, losses and the trigger stay float32
    # (models/layers.py); any other name raises
    compute_dtype: str = "float32"
    # "full" computes the reference's metric-only forwards every batch;
    # "loss_only" skips them.  The training trajectory is identical: none of
    # them feed a gradient and every random draw is made either way.
    train_metrics: str = "full"  # full | loss_only
    pallas_lowfreq: bool = False  # unfused trigger: low-pass as kernel K3 (true) or ATen (false)
    pallas_trigger: bool = True  # whole trigger chain as kernels K1 (fwd) / K2 (bwd)
    remat: str = "none"  # no-op (accepted for flag parity)
    scan_chunk: int = 0  # no-op (accepted for flag parity)
    profile_dir: str = ""  # raises when set (later work)
    debug_nans: bool = False  # torch.autograd anomaly detection
    log_every: int = 1
    image_every: int = 20  # unused: the port logs JSONL scalars only
    synthetic_data: bool = False  # deterministic synthetic dataset (no-network envs)
    synthetic_size: int = 0  # train=N, test=N//5; 0 = CIFAR-scale 50k/10k
    synthetic_label_noise: float = 0.0

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_DATASET_PRESETS = {
    "cifar10": dict(input_height=32, input_width=32, input_channel=3, num_classes=10),
    "celeba": dict(input_height=64, input_width=64, input_channel=3, num_classes=8, num_workers=40),
    "imagenet10": dict(input_height=224, input_width=224, input_channel=3, num_classes=10, bs=32),
    "mnist": dict(input_height=28, input_width=28, input_channel=1, num_classes=10),
    "gtsrb": dict(input_height=32, input_width=32, input_channel=3, num_classes=43),
}


def apply_dataset_preset(cfg: Config) -> Config:
    preset = _DATASET_PRESETS.get(cfg.dataset)
    if preset is None:
        raise ValueError(f"Invalid dataset: {cfg.dataset!r}")
    return cfg.replace(**preset)


def _int_list(text) -> Tuple[int, ...]:
    if isinstance(text, (list, tuple)):
        return tuple(int(x) for x in text)
    return tuple(int(t) for t in str(text).split(",") if t.strip())


def _float_pair(text) -> Tuple[float, float]:
    if isinstance(text, (list, tuple)):
        lo, hi = text
        return (float(lo), float(hi))
    parts = [float(t) for t in str(text).split(",")]
    if len(parts) == 1:
        return (parts[0], parts[0])
    return (parts[0], parts[1])


def _bool(text) -> bool:
    value = str(text).strip().lower()
    if value in ("1", "true", "yes", "on"):
        return True
    if value in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {text!r}")


def build_parser(defaults: Optional[Config] = None) -> argparse.ArgumentParser:
    """CLI with the same flag surface as the JAX package's ``config.py``."""
    d = defaults or Config()
    p = argparse.ArgumentParser()
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        default = getattr(d, f.name)
        if isinstance(default, bool):
            p.add_argument(name, type=_bool, nargs="?", const=True, default=default)
        elif f.name in ("schedulerC_milestones", "schedulerG_milestones", "scheduler_clean_milestones"):
            p.add_argument(name, type=_int_list, default=default)
        elif f.name == "sigma":
            p.add_argument(name, type=_float_pair, default=default)
        elif f.name == "compute_dtype":
            p.add_argument(name, type=str, default=default, help="float32 (or f32), bfloat16 or float16: the dtype "
                           "the convolutions and linears compute in; parameters, BatchNorm, the losses and the "
                           "trigger stay float32")
        elif isinstance(default, int):
            p.add_argument(name, type=int, default=default)
        elif isinstance(default, float):
            p.add_argument(name, type=float, default=default)
        else:
            p.add_argument(name, type=str, default=default)
    return p


def from_args(argv: Optional[Sequence[str]] = None, defaults: Optional[Config] = None) -> Config:
    ns = build_parser(defaults).parse_args(argv)
    cfg = Config(**vars(ns))
    return apply_dataset_preset(cfg)
