"""Shared CLI harness: the device, the device-resident data, run dirs (the
port of ``combat_tpu/cli/common.py``)."""

from __future__ import annotations

import os
import shutil
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data import get_dataset
from ..models import parse_compute_dtype

BANNER = "combat-tpu-torch"
_LATER = "is later work of the port"


def setup_device(cfg: Config) -> torch.device:
    """The device a run uses: ``cuda:0`` for ``--device cuda`` (the default),
    the CPU only for ``--device cpu``.  No fallback: a missing card is an
    error.  TF32 stays off, so what runs in float32 (every op of a float32
    run; the trigger, the DCT features, the augmentation's resample and the
    norms of a ``--compute_dtype bfloat16`` or ``float16`` run) is float32
    as in the JAX package.  The low-precision products reduce in float32, as
    the JAX recipe's do: cuBLAS may otherwise reduce them in their own dtype.
    The models read the dtype from ``cfg`` (``models/registry.py``)."""
    dtype = parse_compute_dtype(cfg.compute_dtype)  # raises on an unknown name
    if cfg.multihost or cfg.n_devices > 1:
        raise NotImplementedError(f"multi-device training {_LATER} (DDP over NCCL)")
    if cfg.profile_dir:
        raise NotImplementedError(f"--profile_dir {_LATER}")
    device = torch.device(cfg.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but torch sees no CUDA device (pass --device cpu to run on the CPU)")
        device = torch.device("cuda", device.index or 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dtype is not None:
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
            torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
        name = torch.cuda.get_device_name(device)
    elif device.type == "cpu":
        name = "cpu"
    else:
        raise ValueError(f"--device must be cuda or cpu, got {cfg.device!r}")
    torch.autograd.set_detect_anomaly(cfg.debug_nans)
    print(f"[{BANNER}] device: {device} ({name}), compute dtype: {dtype or torch.float32}")
    return device


# Above this size a split lives on the device as uint8, as in the JAX
# package (combat_tpu/cli/common.py): a quarter of the float32 footprint
# (imagenet10's 50,000 synthetic 224 px images are 30.1 GB as float32,
# 7.5 GB as uint8).  cifar10-scale splits (614 MB) stay float32.  The epoch
# runners dequantize each gathered batch (train/loop.py::gather_batch).
_U8_RESIDENCY_BYTES = 1 << 30
# Row blocks of the host-side quantization, which bound its float
# temporaries to about this many bytes.
_QUANT_BLOCK_BYTES = 256 << 20


def quantize_rows(images: np.ndarray) -> np.ndarray:
    """[-1, 1] float images -> uint8 ``round((x + 1) * 127.5)``, clipped to
    0..255, in row blocks of about ``_QUANT_BLOCK_BYTES``."""
    u8 = np.empty(images.shape, np.uint8)
    rows = max(1, _QUANT_BLOCK_BYTES // max(1, images[0].nbytes))
    for i in range(0, images.shape[0], rows):
        u8[i : i + rows] = np.clip(np.round((images[i : i + rows] + 1.0) * 127.5), 0, 255)
    return u8


def device_dataset(cfg: Config, device: torch.device, train: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Load a split and move it to the device once: NCHW images and int64
    labels.  The images are float32, or uint8 (:func:`quantize_rows`) when
    the float32 split is larger than ``_U8_RESIDENCY_BYTES``."""
    ds = get_dataset(cfg, train)
    images = ds.images
    if images.nbytes > _U8_RESIDENCY_BYTES:
        print(
            f"[{BANNER}] {'train' if train else 'test'} split ({images.nbytes / 2**30:.2f} GB float32) "
            "stored on the device as uint8 (lossless for uint8-sourced corpora; <=1/255 quantization otherwise)"
        )
        images = quantize_rows(images)
    images = torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1, 2))).to(device)
    labels = torch.from_numpy(ds.labels.astype(np.int64)).to(device)
    return images, labels


def setup_run_dirs(cfg: Config, ckpt_folder: str, log_subdir: str = "log_dir", fresh: Optional[bool] = None) -> str:
    """Create/clean the run directory tree.  Starting fresh deletes the
    checkpoint folder like the reference (``train_generator.py:562``)."""
    if fresh is None:
        fresh = not cfg.continue_training
    if fresh:
        shutil.rmtree(ckpt_folder, ignore_errors=True)
    log_dir = os.path.join(ckpt_folder, log_subdir)
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def steps_per_epoch(n: int, bs: int) -> int:
    """Optimizer steps per epoch: full batches + the ragged tail batch."""
    return max(1, -(-n // bs))


def warn_on_cadence_change(payload: dict, spe: int) -> None:
    """Warn when a resumed checkpoint was trained at another number of steps
    per epoch (the JAX CLIs' warning; a stored 0 or none counts as unknown).
    The resumed schedules re-anchor their milestones either way."""
    saved_spe = int(payload.get("scheduler_steps_per_epoch", spe)) or spe
    if saved_spe != spe:
        print(
            f"WARNING: checkpoint was trained at {saved_spe} steps/epoch but the "
            f"current dataset gives {spe}; re-anchoring the remaining LR milestones "
            "on the new cadence (epoch-indexed MultiStepLR semantics)"
        )


def fmt_pct(x: float) -> str:
    return f"{x:.4f}"
