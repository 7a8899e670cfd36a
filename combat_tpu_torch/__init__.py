"""COMBAT in PyTorch for an NVIDIA H100: the port of ``combat_tpu``.

The JAX package ``combat_tpu`` stays the reference; this package imports
nothing of it and nothing of JAX.  Module names follow the JAX package so a
reader finds each counterpart:

  config      — typed Config + dataset presets + CLI flags (own copy)
  data        — numpy datasets: synthetic, CIFAR-10 bin / pickle, npz;
                the victim stage's poison mask
  ops         — DCT low-pass, Gaussian blur, train-time augmentation, image
                resampling (resize, grid sample, total variation), and the
                hand-written CUDA trigger kernels (trigger_kernels)
  models      — PreActResNet18, the trigger generators (UNet, UNet-BK, Grid,
                Mixed, class-conditional UNet, fixed), FrequencyModel (NCHW)
  attack      — trigger synthesis (additive, WaNet warp) + target mapping
  train       — optimizer/schedule, train state, fused steps (base and the
                WaNet, input-aware, imperceptible, multilabel variants),
                epoch loops
  checkpoint  — torch.save checkpoints + conversion from JAX parameters
  cli         — train_clean_classifier, train_generator, train_victim and
                eval, and the variants' train_generator_* / train_victim_*

Entry points run on ``cuda:0`` unless the caller passes ``--device cpu``.
"""

__version__ = "0.1.0"

from .config import Config, apply_dataset_preset, from_args  # noqa: F401
