#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``combat_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printing one line with its seconds:
  1. the card's name and power limit (nvidia-smi), then one ``nvcc`` build
     of the trigger kernels K1-K3 (``combat_tpu_torch/csrc/trigger.cu``);
  2. each kernel, forward and backward, held to its plain PyTorch version
     (K1/K2 at 32 and 64 px, 3 and 5 taps, two sigmas, 384 and 383 planes;
     K3 at 32 and 64 px and cutoffs c = 1, 0.65 H and H, also through
     autograd), and timed with CUDA events at the slice's shapes (bs 128,
     3 x 32 x 32 f32) beside its plain version and the same function as
     dense ``torch.matmul``s (``library_ms``); also at 64 px, and their
     device durations traced with ``torch.profiler``; then the tiled
     kernels above 64 px held to their plain versions at 224 px (96
     planes, imagenet10's bs 32; K3 within 2e-5) and at H = 100, and timed
     at 224 px beside their plain versions, a ``torch.matmul`` chain with
     the projector P and two bounds (with the products on the tensor cores
     in three TF32 passes, as the kernels run them, and in float32 FMA),
     with their traced device time summed over each chain's launches and
     split into products, K1's one-pass blur and K2's one-pass adjoint
     blur, each pass beside its own byte bound (the ``h224`` entry of each
     kernel's row); the tiled kernels are held at 257 and 300 px too, where
     the products read the projector's depth in windows;
  3. ``train_clean_classifier`` at full width (PreActResNet18, bs 128,
     1024 synthetic images: 8 steps, then eval);
  4. ``train_generator`` on that checkpoint, fused trigger (K1/K2): 8
     alternated steps with UNet nf=64, then the attack eval, with the
     committed cifar10 frequency detector loaded;
  5. ``train_generator --pallas_trigger false --pallas_lowfreq true`` (K3,
     then clamp and blur): 2 alternated steps;
  5b. ``train_generator --pallas_trigger false --pallas_lowfreq false`` (the
     ATen route): 2 alternated steps, and no trigger kernel launched;
  5c. ``train_victim`` on phase 4's generator, fused trigger: 1024 images
     (8 steps), then the victim eval; K1 launched, K2 not (G is frozen);
  5d. ``train_victim --pallas_trigger false --pallas_lowfreq true``: 256
     images (2 steps) and eval; K3 launched, K1 and K2 not;
  5e. ``eval`` of 5c's victim with phase 4's generator: Clean Acc, Bd BA and
     Bd ASR finite and in [0, 100]; K1 launched, K2 not;
  5f-5k. the attack variants, each at 256 images (2 steps, then eval) with
     the launch counts set to 0 before it and held after it to the counts
     in ``VARIANT_PHASES``: the WaNet, input-aware (K1/K2 and K3 routes),
     imperceptible and multilabel generators, then the WaNet, input-aware,
     imperceptible and multilabel victims on those generators;
  5l-5q. celeba and imagenet10, each phase held to the counts in
     ``LARGE_PHASES``: 5l the celeba clean classifier and generator (64 px,
     ResNet18, bs 128, 256 images), the generator on the committed celeba
     detector; then imagenet10 (224 px, ResNet18, bs 32, 64 images: 2
     steps, then eval), through the tiled kernels: 5m the clean
     classifier, 5n the generator (K1/K2), 5o the generator on K3, 5p the
     victim (K1), 5q the final eval;
  5r-5t. ``--compute_dtype bfloat16``, each phase held to the counts in
     ``BF16_PHASES``, which are its float32 counterpart's (the trigger stays
     float32): 5r the cifar10 clean classifier, generator (K1/K2 and K3),
     victim and eval, 5s the input-aware and multilabel generators, 5t the
     imagenet10 generator at 224 px (the tiled K1/K2) on 5m's float32
     clean model and a float32 victim of it; every checkpoint holds float32
     parameters and statistics;
  5u-5w. the rest of the model registry, each phase held to the counts in
     ``ZOO_PHASES`` (cifar10 or gtsrb, bs 128, 256 images: 2 steps, then
     one eval batch): 5u ``--model vgg16``, ``densenet121`` and
     ``simplevitsmall8`` through the four stages, and every other new name
     through a clean classifier and a generator; 5v ``--F_model
     original_dropout``, ``original_dropout_ensemble`` and ``densenet121``
     through a generator and eval, each with a random detector recorded as
     such (no ``.pt`` of theirs is in the repo), and the frozen ensemble's
     logits drawn anew a call on the card; 5w gtsrb (43 classes) through
     the four stages;
  5x-5z. the defenses (``combat_tpu_torch/defenses/``), each phase held to
     the counts in ``DEFENSE_PHASES`` and its files checked in the JAX
     formats, run from the work folder: 5x the frequency detector on cifar10
     (``frequency_train --F_model original_dropout``, 2 epochs of 256
     images; the generator on that detector, which it must load; its
     ``frequency_eval``; ``frequency_train --F_model preactresnet18``, the
     Adam branch); 5y STRIP (attack and clean, 2 rounds of 100 x 100),
     Neural Cleanse (10 labels, 2 epochs) and ``combine_images``,
     fine-pruning (513 masks over the 10,000-row split) and Grad-CAM, on
     the checkpoints of phases 3-5; 5z STRIP, fine-pruning and the
     ``original`` detector's training and trigger test at 224 px on those
     of 5m-5q (the tiled K1);
  5za-5zc. the extended zoo (``models/zoo_extra.py``), each phase held to
     the counts in ``ZOO_EXTRA_PHASES``, ``ZOO_EXTRA_DETECTOR_PHASES`` and
     ``ZOO_EXTRA_224_PHASES``: 5za ``--model googlenet``, ``dpn92`` and
     ``senet18`` through the four stages and the nine other trainable
     names through a clean classifier and a generator (cifar10, bs 128,
     256 images), then ``--model efficientnetb0``, whose C-step stops with
     the ``NotImplementedError`` the run asserts and prints (the JAX
     C-steps pass its dropout no rng); 5zb ``frequency_train --F_model
     efficientnetb0`` (2 epochs of 256 images, its broadcast dropout masks
     drawn on the card), a generator that must load that detector and its
     ``frequency_eval``, and ``--F_model shufflenetv2`` in a generator, a
     random detector recorded as such; 5zc celeba (64 px) ShuffleNetG2 and
     imagenet10 (224 px, bs 32, 64 images, the tiled K1/K2) MobileNetV1,
     each a clean classifier and a generator, with the peak device memory
     of the latter two;
  5zd. ``train_generator`` on cifar10 at 256 images for two epochs with
     ``--image_every 1 --profile_dir``: its launches as predicted, one
     ``torch.profiler`` trace of the second epoch whose CUDA kernels include
     K1's and K2's, the traced epoch's ten costliest device operations
     printed, and the grids and scalars read back from the tensorboard
     event file (where tensorboard is importable; else the JSONL record);
  5ze. the committed cifar10 detector and phase 4's attack checkpoint
     written in the reference's ``.pth.tar`` layout (a key table of this
     script's own), imported by ``python -m
     combat_tpu_torch.checkpoint.torch_import`` under ``weights_only`` and
     held to the originals bit for bit; ``eval`` on the imported attack
     gives the metrics it gives on the original, through K1;
  5zf. ``train_generator``, ``train_victim`` and ``eval`` (256 images, on
     phase 3's clean model) with ``--multihost`` over NCCL at world size 1
     (a coordinator on this host), each held to the same flags without
     ``--multihost``: equal metrics and checkpoints (C and G of the
     generator stage to 1e-5: the UNet upsampling's backward adds with
     atomics; a third run with the same flags shows the card's own
     spread), the launches as ``ZF_STAGES`` predict;
  5zg. ``train_generator --remat step`` (256 images, on phase 3's clean
     model) against the same flags without it, run twice: equal metrics, C
     and G to 5zf's 1e-5, each run's launches as ``ZG_ARMS`` predict (the
     checkpointed G-step recomputes its trigger: one more K1 a step);
  5zh-5zi. the four variants (``VARIANT_LARGE_PHASES``, each stage held to
     its counts): the WaNet, input-aware, imperceptible and multilabel
     generators and their victims at celeba (64 px, bs 128, 256 images, on
     5l's clean classifier and the committed celeba detector; the one-plane
     K1/K2 at their largest H), then at imagenet10 (224 px, bs 32, 64
     images, on 5m's, a random detector recorded as such; the tiled K1/K2
     in the input-aware and multilabel call patterns); then the
     input-aware and multilabel train steps at 224 px, bs 32, on the K1/K2
     route against the ATen route from the same weights and draws, within
     ``ROUTE_GAIN`` times the gap that Gaussian noise of phase 2's largest
     K1/K2 error on the images makes (``route_parity``);
  Every alternated stage (a generator, and the multilabel victim) also
  writes the ``--image_every`` grid at epoch 0 where tensorboard is
  importable: one more K1 launch (K3 on the K3 route, none on ATen's or
  for the WaNet warp), which ``with_grid`` adds to each phase's prediction;
  6. one alternated step and one victim step at full width on the card
     against the same step on the CPU, from the same weights and draws, one
     input-aware and one multilabel step (bs 32), and one alternated step
     at 96 px (ResNet18, bs 4) where the tiled K1/K2 run inside the step,
     and one alternated step with DenseNet121 as C and the clean model and
     the dropout-ensemble detector, its masks drawn once and given to both,
     one alternated step with DPN26 (bs 128; its 32-group convolutions),
     one train step of the ``original`` frequency detector (bs 128)
     from the same corruption draws and dropout masks, and one of an
     EfficientNetB0 detector (its broadcast masks drawn once, held by its
     gradients);
     then the alternated and victim steps in bfloat16 on the card and on
     the CPU on six seeds, held by the gap criterion of
     ``combat_tpu_torch/utils/gap.py`` with the card's float32 step as the
     yardstick;
  7. the steady-state alternated step at full width (bs 128), timed on the
     host clock around synchronised runs of 5 steps after 2, on the three trigger
     routes (K1/K2, K3, ATen) and in both metric modes, the victim step
     on the K1 and ATen routes, and each variant's step on the K1/K2 route
     and the WaNet victim step, each with its peak device memory; then (3
     steps each, in bfloat16 one after one warm-up) the alternated and
     victim steps with VGG16, MobileNetV2, DenseNet121, ViT, ViT-small and
     the extended zoo's twelve trainable names as C, the imagenet10
     alternated step at 224 px, bs 32 on the K1/K2 and ATen routes with the
     K1/K2 step's peak device memory, the imagenet10 victim step, and the
     celeba alternated step (bs 128); all of it in float32, then in
     bfloat16, each row named by its dtype; the variants' rows again at
     imagenet10 (224 px, bs 32, K1/K2, float32, 3 steps); then
     the defenses in both
     dtypes (fine-pruning's trunk pass and heads per mask, one STRIP round,
     one Neural Cleanse step, one detector train step) and the hoisted
     fine-pruning sweep against a per-mask sweep on 32 images; then the
     float32 alternated step at cifar10 (bs 128) and imagenet10 (224 px, bs
     32) with ``--remat none`` and ``step``, each with its peak device
     memory.
  6-dp (after phase 6). two processes on cuda:0 in a gloo group of their
     own (``train/mesh.py``), each running an alternated epoch, an attack
     eval and a victim epoch through ``train/loop.py`` at global bs 128 on
     259 rows (a ragged tail of 3: 2 rows and 1) at full width, held to
     each other bit for bit and to the same epochs in this process alone
     (``DP_UPDATE_TOL``, ``DP_STATS_TOL``; the one process runs twice, the
     second time with cuDNN deterministic, and the two runs' spread is
     printed beside), each run's launches as ``DP_PREDICTED``; each rank
     first calls K1-K3's wrappers on 0 planes, which launch nothing;
  6-tp. four processes on cuda:0 as the 2 x 2 (data, model) grid
     (``train/mesh.py``: C, G, the clean model and the detector
     channel-sharded over the model axis) run 6-dp's epochs, held to 6-dp's
     one-process runs (``TP_UPDATE_TOL``, ``TP_STATS_TOL``,
     ``TP_LOSS_TOL``), their blocks and replicated tensors bit-equal where
     they must be, each rank's resident bytes printed (half the sharded
     share), each rank's launches as ``TP_PREDICTED``;
  6-mc (started with phase 6, which times nothing). ``python -m
     combat_tpu_torch.multichip 4 --backend gloo`` (the JAX dryrun: the full
     alternated step data-parallel, then on the 2 x 2 grid) prints its two
     lines, their losses within its tolerance, and launches as
     ``MC_PREDICTED``.
Then one JSON line of the kernels (launches on the main path, phases 3-5,
5c-5e, 5f-5k, 5l-5q, 5r-5t, 5u-5w, 5x-5z, 5za-5zc, 5zd-5zg, 5zh-5zi (not
the route parity's, which compares the routes), 6-dp (both
ranks and the one process), 6-tp (the four ranks) and 6-mc (its ranks),
errors, times, bounds)
and, last,
``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when torch sees no CUDA device or the
package is missing; any failed check or phase raises.  A hang ends after
1140 s (``HANG_S``) as a traceback and a non-zero exit, inside the 1200 s a
run may take: the script took 536-865 s on an H100 machine before phases
5zh-5zi, which add ~80 s (phase 7's bfloat16 registry rows went from 2 + 3
steps to 1 + 1 for them), and its shared host sets the CPU-bound phases 6
and 7.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import faulthandler
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12  # H100 SXM TF32 on the tensor cores, dense
KERNEL_TOL = 1e-4  # float32 FMA in another order than cuBLAS; values O(1)
TILED_K3_TOL = 2e-5  # tiled K3 at 224 px: three TF32 passes keep float32 accuracy, one pass errs ~1e-3
BS, C, H = 128, 3, 32
HANG_S = 1140  # the whole run's hang limit
RATIO, NOISE_RATE = 0.65, 0.08
H_LARGE, PLANES_LARGE = 224, 32 * 3  # imagenet10: bs 32, 3 x 224 x 224


def _phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def _event_ms(fn, iters: int = 100) -> float:
    """Device time of ``fn`` per call: captured once in a CUDA graph and
    replayed ``iters`` times between CUDA events, so host dispatch is not
    counted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes: int, flops: int, tf32_flops: int = 0):
    """The least time for the work: the larger of its bytes over the HBM
    rate and its operations, float32 FMA over the float32 rate plus
    tensor-core TF32 operations over the TF32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S + tf32_flops / TF32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _err(a, b) -> float:
    return float((a - b).detach().abs().max())


def _trigger_inputs(h: int, seed: int):
    """(x, noise, g) as 384 planes of h x h, one per (image, channel)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((BS * C, 1, h, h), generator=gen, device="cuda") * 2 - 1
    noise = torch.rand((BS * C, 1, h, h), generator=gen, device="cuda") * 2 - 1
    g = torch.randn((BS * C, 1, h, h), generator=gen, device="cuda")
    return x, noise, g


def check_fused_trigger() -> dict:
    """K1 and K2 against their plain versions at 32 and 64 px, 3 and 5 taps,
    a small and a large sigma (B^T != B at the borders), and a full and a
    ragged plane count; returns the largest error of each."""
    import torch

    from combat_tpu_torch.ops import trigger_kernels as tk
    from combat_tpu_torch.ops.blur import blur_matrix, gaussian_kernel_1d

    worst = {"fused_trigger_fwd": 0.0, "fused_trigger_bwd": 0.0}
    for h in (32, 64):
        D, M = tk.trigger_operands(h, RATIO, "cuda")
        Dc = tk.truncated_dct(h, RATIO, "cuda")
        full = _trigger_inputs(h, seed=h)
        for k in (3, 5):
            for sigma in (0.14, 0.9):
                taps = gaussian_kernel_1d(k, sigma, device="cuda")
                B = blur_matrix(taps, h)
                for planes in (BS * C, BS * C - 1):
                    x, noise, g = (t[:planes] for t in full)
                    out, u = tk.fused_trigger_fwd(x, noise, taps, Dc, NOISE_RATE)
                    gx, gn = tk.fused_trigger_bwd(g, u, taps, Dc, NOISE_RATE)
                    ref_out, ref_u = tk.fused_trigger_fwd_plain(x, noise, B, D, M, NOISE_RATE)
                    # K2 on the same inputs, K1's own u: where u lies within
                    # rounding of +-1 the plain u's clamp mask could differ.
                    ref_gx, ref_gn = tk.fused_trigger_bwd_plain(g, u, B, D, M, NOISE_RATE)
                    fwd = max(_err(out, ref_out), _err(u, ref_u))
                    bwd = max(_err(gx, ref_gx), _err(gn, ref_gn))
                    print(f"  K1/K2 H={h} k={k} sigma={sigma} planes={planes}: "
                          f"fwd {fwd:.3e}, bwd {bwd:.3e}", flush=True)
                    worst["fused_trigger_fwd"] = max(worst["fused_trigger_fwd"], fwd)
                    worst["fused_trigger_bwd"] = max(worst["fused_trigger_bwd"], bwd)
    return worst


def check_low_freq() -> float:
    """K3 against its plain version (the JAX kernel's dense D, M form) at 32
    and 64 px and the cutoffs c = 1, int(0.65 H) and H, forward and through
    autograd (K3 on the cotangent against autograd through the plain chain);
    returns the largest error."""
    import torch

    from combat_tpu_torch.ops import trigger_kernels as tk
    from combat_tpu_torch.ops.dct import low_freq

    worst = 0.0
    for h in (32, 64):
        x, _, g = _trigger_inputs(h, seed=h + 1)
        for ratio in (1.5 / h, RATIO, 1.0):
            D, M = tk.trigger_operands(h, ratio, "cuda")
            xt = x.clone().requires_grad_()
            out = low_freq(xt, h, ratio, use_kernel=True)
            (gx,) = torch.autograd.grad(out, xt, grad_outputs=g)
            xp = x.clone().requires_grad_()
            ref = tk.low_freq_plain(xp, D, M)
            (ref_gx,) = torch.autograd.grad(ref, xp, grad_outputs=g)
            fwd = max(_err(out, ref), _err(tk.low_freq_planes(x, ratio), ref))
            bwd = _err(gx, ref_gx)
            print(f"  K3 H={h} c={int(h * ratio)}: fwd {fwd:.3e}, bwd {bwd:.3e}", flush=True)
            worst = max(worst, fwd, bwd)
    return worst


def compare_kernels():
    """Phase 2: each kernel against its plain version, and its times."""
    import torch

    from combat_tpu_torch.ops import trigger_kernels as tk
    from combat_tpu_torch.ops.blur import blur_matrix, gaussian_kernel_1d

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((BS, C, H, H), generator=gen, device=dev) * 2 - 1
    noise = torch.rand((BS, C, H, H), generator=gen, device=dev) * 2 - 1
    g = torch.randn((BS, C, H, H), generator=gen, device=dev)
    taps = gaussian_kernel_1d(3, 0.9, device=dev)
    B = blur_matrix(taps, H)  # large sigma: B^T != B matters
    D, M = tk.trigger_operands(H, RATIO, str(dev))
    Dc = tk.truncated_dct(H, RATIO, str(dev))
    planes, plane_bytes, mat_bytes = BS * C, BS * C * H * H * 4, H * H * 4

    # The same functions as dense matmuls on (planes, H*H) rows (the yardstick):
    # the low-pass is one (H*H)^2 operator, the blur another.
    kD = torch.kron(D, D)
    L_t = (kD.T @ torch.diag(M.reshape(-1)) @ kD).T.contiguous()
    Bk_t = torch.kron(B, B).T.contiguous()
    flat = lambda t: t.reshape(planes, H * H)  # noqa: E731

    def lib_fwd():
        u = torch.addmm(flat(x), flat(noise), L_t, alpha=NOISE_RATE)  # low_freq(n) == L n: the DC passes
        return torch.matmul(u.clamp(-1.0, 1.0), Bk_t), u

    def lib_bwd(u):
        gu = torch.matmul(flat(g), Bk_t.T) * ((u >= -1.0) & (u <= 1.0))
        return gu, torch.matmul(gu, L_t) * NOISE_RATE

    errors = check_fused_trigger()
    errors["low_freq"] = check_low_freq()
    for name, e in check_tiled().items():
        errors[name] = max(errors[name], e)
    out, u = tk.fused_trigger_fwd(x, noise, taps, Dc, NOISE_RATE)
    low = tk.low_freq_planes(x, RATIO)
    ref_out, ref_u = tk.fused_trigger_fwd_plain(x, noise, B, D, M, NOISE_RATE)
    ref_gx, ref_gn = tk.fused_trigger_bwd_plain(g, ref_u, B, D, M, NOISE_RATE)
    ref_low = tk.low_freq_plain(x, D, M)
    ref_low_bwd = tk.low_freq_plain(g, D, M)
    low_bwd = tk.low_freq_planes(g, RATIO)  # K3's backward: the same kernel on the cotangent
    lib_out, lib_u = lib_fwd()
    lib_gx, lib_gn = lib_bwd(lib_u)
    torch.cuda.synchronize()

    errors["low_freq"] = max(errors["low_freq"], _err(low, ref_low), _err(low_bwd, ref_low_bwd))
    lib_err = max(_err(lib_out, flat(ref_out)), _err(lib_gx, flat(ref_gx)), _err(lib_gn, flat(ref_gn)))
    for name, e in errors.items():
        print(f"  {name}: max |kernel - plain| = {e:.3e} (tolerance {KERNEL_TOL:.0e})", flush=True)
    print(f"  dense-matmul yardstick: max |library - plain| = {lib_err:.3e} (tolerance 1e-3)", flush=True)
    bad = {k: e for k, e in errors.items() if not e <= KERNEL_TOL}
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")
    if not lib_err <= 1e-3:
        raise SystemExit(f"the dense-matmul yardstick disagrees with the plain version: {lib_err}")

    times = {
        "fused_trigger_fwd": (
            _event_ms(lambda: tk.fused_trigger_fwd(x, noise, taps, Dc, NOISE_RATE)),
            _event_ms(lambda: tk.fused_trigger_fwd_plain(x, noise, B, D, M, NOISE_RATE)),
            _event_ms(lib_fwd),
        ),
        "fused_trigger_bwd": (
            _event_ms(lambda: tk.fused_trigger_bwd(g, u, taps, Dc, NOISE_RATE)),
            _event_ms(lambda: tk.fused_trigger_bwd_plain(g, u, B, D, M, NOISE_RATE)),
            _event_ms(lambda: lib_bwd(lib_u)),
        ),
        "low_freq": (
            _event_ms(lambda: tk.low_freq_planes(x, RATIO)),
            _event_ms(lambda: tk.low_freq_plain(x, D, M)),
            _event_ms(lambda: torch.matmul(flat(x), L_t)),
        ),
    }
    time_trigger_variants(taps, Dc)
    large = time_tiled()
    # Bytes: each input read once, each output written once; K1/K2 read D_c
    # and the taps once per call, K3 the projector P.  Operations: the least
    # the function needs per plane (one FMA = 2).  The low-pass keeps only
    # the c x c corner of the coefficients: the fewer FMAs of its truncated
    # form, 2c*H*H + 2c*c*H, and of P y P, 2*H^3; its affine pre- and
    # post-scaling folds away (the DC passes the mask).  The blur B c B^T
    # (and B^T g B) is banded: one pass per side of `taps` FMAs per output.
    # Elementwise: u = x + r*low and the clamp (4) forward; the clamp mask
    # (3) backward.
    c = Dc.shape[0]
    lowpass = 2 * min(2 * c * H * H + 2 * c * c * H, 2 * H ** 3)
    blur = 2 * (2 * H * H * taps.numel())
    trigger_bytes = 4 * plane_bytes + Dc.numel() * 4 + taps.numel() * 4
    work = {
        "fused_trigger_fwd": (trigger_bytes, (lowpass + blur + 4 * H * H) * planes),
        "fused_trigger_bwd": (trigger_bytes, (lowpass + blur + 3 * H * H) * planes),
        "low_freq": (2 * plane_bytes + mat_bytes, lowpass * planes),
    }
    source = "combat_tpu_torch/csrc/trigger.cu"
    replaces = {
        "fused_trigger_fwd": "combat_tpu/ops/pallas_kernels.py:128",
        "fused_trigger_bwd": "combat_tpu/ops/pallas_kernels.py:154",
        "low_freq": "combat_tpu/ops/pallas_kernels.py:217",
    }
    rows = {}
    for name in errors:
        ms, plain_ms, library_ms = times[name]
        bound_ms, bound_by = _bound_ms(*work[name])
        rows[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces[name],
            "launches": 0, "max_abs_err": errors[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms, "h224": large[name],
        }
        print(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f}, dense matmuls {library_ms:.4f}, "
              f"bound {bound_ms:.4f} by {bound_by})", flush=True)
    return rows


def time_trigger_variants(taps, Dc) -> None:
    """K1-K3 at 64 px (384 planes, c = 41) beside their plain versions, then
    their device durations from a profiler trace: at 384 planes and at one
    plane per SM (every block resident at once, so the duration is one
    block's latency) of 32x32, and at 384 planes of 64x64."""
    import torch

    from combat_tpu_torch.ops import trigger_kernels as tk
    from combat_tpu_torch.ops.blur import blur_matrix

    h = 64
    x, noise, g = _trigger_inputs(h, seed=5)
    D, M = tk.trigger_operands(h, RATIO, "cuda")
    Dc64 = tk.truncated_dct(h, RATIO, "cuda")
    B = blur_matrix(taps, h)
    u = tk.fused_trigger_fwd(x, noise, taps, Dc64, NOISE_RATE)[1]
    fwd = (_event_ms(lambda: tk.fused_trigger_fwd(x, noise, taps, Dc64, NOISE_RATE)),
           _event_ms(lambda: tk.fused_trigger_fwd_plain(x, noise, B, D, M, NOISE_RATE)))
    bwd = (_event_ms(lambda: tk.fused_trigger_bwd(g, u, taps, Dc64, NOISE_RATE)),
           _event_ms(lambda: tk.fused_trigger_bwd_plain(g, u, B, D, M, NOISE_RATE)))
    low = (_event_ms(lambda: tk.low_freq_planes(x, RATIO)), _event_ms(lambda: tk.low_freq_plain(x, D, M)))
    print(f"  H=64: fused_trigger_fwd {fwd[0]:.4f} ms (plain {fwd[1]:.4f}); "
          f"fused_trigger_bwd {bwd[0]:.4f} ms (plain {bwd[1]:.4f}); "
          f"low_freq {low[0]:.4f} ms (plain {low[1]:.4f})", flush=True)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for h, planes, dc in ((H, sms, Dc), (H, BS * C, Dc), (64, BS * C, Dc64)):
        x, noise, g = (t[:planes] for t in _trigger_inputs(h, seed=8))
        u = tk.fused_trigger_fwd(x, noise, taps, dc, NOISE_RATE)[1]
        traced = _traced_us({
            "fused_trigger_fwd_kernel": lambda: tk.fused_trigger_fwd(x, noise, taps, dc, NOISE_RATE),
            "fused_trigger_bwd_kernel": lambda: tk.fused_trigger_bwd(g, u, taps, dc, NOISE_RATE),
            "low_freq_kernel": lambda: tk.low_freq_planes(x, RATIO),
        })
        print(f"  traced device duration, {planes} planes of {h}x{h}: "
              + ", ".join(f"{k} {v}" for k, v in traced.items()), flush=True)


def _traced_us(calls: dict, reps: int = 50) -> dict:
    """Mean, min and max device duration (us) of each kernel, by a substring
    of its name, over ``reps`` launches traced by ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    out = {}
    for key in calls:
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and key in e.name]
        out[key] = (f"mean {sum(us) / len(us):.3f} us (min {min(us):.3f}, max {max(us):.3f}, n {len(us)})"
                    if us else "not measured (no device event in the trace)")
    return out


def check_tiled() -> dict:
    """K1-K3 above 64 px (the tiled kernels of ``csrc/trigger_tiled.cuh``)
    against their plain versions: at 224 px (96 planes, imagenet10's bs 32),
    at H = 100 (not a multiple of the 64-wide tile; 383 planes), and at 257
    and 300 px, where the products read the projector's depth in windows of
    224.  K1/K2 forward and backward with 3, 5 and 9 taps (sigma 0.9: B^T !=
    B; 9 taps reach past one 8-tap chunk of the blur's passes), K3 forward
    and through autograd.  Returns the largest error of
    each."""
    import torch

    from combat_tpu_torch.ops import trigger_kernels as tk
    from combat_tpu_torch.ops.blur import blur_matrix, gaussian_kernel_1d
    from combat_tpu_torch.ops.dct import low_freq

    worst = dict.fromkeys(KERNEL_NAMES, 0.0)
    for h, planes in ((H_LARGE, PLANES_LARGE), (100, BS * C - 1), (257, PLANES_LARGE), (300, PLANES_LARGE - 1)):
        x, noise, g = (t[:planes] for t in _trigger_inputs(h, seed=h))
        D, M = tk.trigger_operands(h, RATIO, "cuda")
        Dc = tk.truncated_dct(h, RATIO, "cuda")
        for k in (3, 5, 9):
            taps = gaussian_kernel_1d(k, 0.9, device="cuda")
            B = blur_matrix(taps, h)
            out, u = tk.fused_trigger_fwd(x, noise, taps, Dc, NOISE_RATE)
            gx, gn = tk.fused_trigger_bwd(g, u, taps, Dc, NOISE_RATE)
            ref_out, ref_u = tk.fused_trigger_fwd_plain(x, noise, B, D, M, NOISE_RATE)
            ref_gx, ref_gn = tk.fused_trigger_bwd_plain(g, u, B, D, M, NOISE_RATE)  # on K1's own u
            fwd = max(_err(out, ref_out), _err(u, ref_u))
            bwd = max(_err(gx, ref_gx), _err(gn, ref_gn))
            print(f"  tiled K1/K2 H={h} k={k} planes={planes}: fwd {fwd:.3e}, bwd {bwd:.3e}", flush=True)
            worst["fused_trigger_fwd"] = max(worst["fused_trigger_fwd"], fwd)
            worst["fused_trigger_bwd"] = max(worst["fused_trigger_bwd"], bwd)
        xt, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
        out = low_freq(xt, h, RATIO, use_kernel=True)
        (gx,) = torch.autograd.grad(out, xt, grad_outputs=g)
        ref = tk.low_freq_plain(xp, D, M)
        (ref_gx,) = torch.autograd.grad(ref, xp, grad_outputs=g)
        err = max(_err(out, ref), _err(gx, ref_gx))
        print(f"  tiled K3 H={h} planes={planes}: fwd and autograd {err:.3e}", flush=True)
        if h == H_LARGE and not err <= TILED_K3_TOL:
            raise SystemExit(f"tiled K3 at {h} px is {err:.3e} from its plain version (tolerance {TILED_K3_TOL:.0e})")
        worst["low_freq"] = max(worst["low_freq"], err)
    return worst


def time_tiled() -> dict:
    """K1-K3 at 224 px, 96 planes (imagenet10, bs 32), each beside its plain
    version and one PyTorch call chain of the same function (the projector's
    two products as batched ``torch.matmul``, the blur as dense ``B``
    products, TF32 off), with its device time from a profiler trace summed
    over the chain's launches and split by part, and two bounds: with the
    products on the tensor cores in three TF32 passes (``bound_ms``, what
    the kernels run) and in float32 FMA (``bound_f32_fma_ms``); K1's blur
    and K2's adjoint blur also beside their own byte bound (``pass_bound_us``:
    the planes each pass reads and writes once, two for the blur, three for
    the adjoint).  Returns a dict per kernel."""
    import torch

    from combat_tpu_torch.ops import trigger_kernels as tk
    from combat_tpu_torch.ops.blur import blur_matrix, gaussian_kernel_1d

    h, planes = H_LARGE, PLANES_LARGE
    x, noise, g = (t[:planes].contiguous() for t in _trigger_inputs(h, seed=9))
    taps = gaussian_kernel_1d(3, 0.9, device="cuda")
    B = blur_matrix(taps, h)
    D, M = tk.trigger_operands(h, RATIO, "cuda")
    Dc = tk.truncated_dct(h, RATIO, "cuda")
    P = tk.lowpass_projector(h, RATIO, "cuda")
    u = tk.fused_trigger_fwd(x, noise, taps, Dc, NOISE_RATE)[1]

    def lib_fwd():  # low_freq(n) = P n P once the DC passes
        uu = torch.matmul(P, torch.matmul(noise, P)) * NOISE_RATE + x
        return torch.matmul(B, torch.matmul(uu.clamp(-1.0, 1.0), B.T)), uu

    def lib_bwd():
        gu = torch.matmul(B.T, torch.matmul(g, B)) * ((u >= -1.0) & (u <= 1.0))
        return gu, torch.matmul(P, torch.matmul(gu, P)) * NOISE_RATE

    def lib_low():
        return torch.matmul(P, torch.matmul(x, P))

    ref_fwd = tk.fused_trigger_fwd_plain(x, noise, B, D, M, NOISE_RATE)
    ref_bwd = tk.fused_trigger_bwd_plain(g, u, B, D, M, NOISE_RATE)
    lib_err = max(*(_err(a, b) for a, b in zip(lib_fwd(), ref_fwd)), *(_err(a, b) for a, b in zip(lib_bwd(), ref_bwd)),
                  _err(lib_low(), tk.low_freq_plain(x, D, M)))
    print(f"  224 px library chain: max |library - plain| = {lib_err:.3e} (tolerance 1e-3)", flush=True)
    if not lib_err <= 1e-3:
        raise SystemExit(f"the 224 px library chain disagrees with the plain version: {lib_err}")
    calls = {
        "fused_trigger_fwd": (lambda: tk.fused_trigger_fwd(x, noise, taps, Dc, NOISE_RATE),
                              lambda: tk.fused_trigger_fwd_plain(x, noise, B, D, M, NOISE_RATE), lib_fwd),
        "fused_trigger_bwd": (lambda: tk.fused_trigger_bwd(g, u, taps, Dc, NOISE_RATE),
                              lambda: tk.fused_trigger_bwd_plain(g, u, B, D, M, NOISE_RATE), lib_bwd),
        "low_freq": (lambda: tk.low_freq_planes(x, RATIO), lambda: tk.low_freq_plain(x, D, M), lib_low),
    }
    # Bytes: each input and output once, and P.  Operations: the two
    # products with P (2 H^3 FMA a plane, fewer than the truncated chain's
    # 2cH^2 + 2c^2H at c = 145), the 3-tap band on each side, elementwise.
    # The kernels run the products on the tensor cores in three TF32 passes
    # (3 x the products' operations at the TF32 rate), the rest in float32.
    c = Dc.shape[0]
    lowpass = 2 * min(2 * c * h * h + 2 * c * c * h, 2 * h ** 3)
    blur = 2 * (2 * h * h * taps.numel())
    plane_bytes, mat_bytes = planes * h * h * 4, h * h * 4
    trigger_bytes = 4 * plane_bytes + mat_bytes + taps.numel() * 4
    passes = {"fused_trigger_fwd": ("blur", 2), "fused_trigger_bwd": ("adjoint", 3)}  # the pass, arrays it moves
    work = {  # (bytes, products' operations, other operations)
        "fused_trigger_fwd": (trigger_bytes, lowpass * planes, (blur + 4 * h * h) * planes),
        "fused_trigger_bwd": (trigger_bytes, lowpass * planes, (blur + 3 * h * h) * planes),
        "low_freq": (2 * plane_bytes + mat_bytes, lowpass * planes, 0),
    }
    out = {}
    for name, (kernel, plain, lib) in calls.items():
        nbytes, products, other = work[name]
        bound_ms, bound_by = _bound_ms(nbytes, other, 3 * products)
        bound_f32_ms, _ = _bound_ms(nbytes, products + other)
        traced = _traced_chain_us(kernel)
        out[name] = {"planes": planes, "H": h, "ms": _event_ms(kernel), "traced_us": traced, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_f32_fma_ms": bound_f32_ms, "plain_ms": _event_ms(plain),
                     "library_ms": _event_ms(lib)}
        if name in passes:
            part, n_planes = passes[name]
            out[name]["pass_bound_us"] = {part: n_planes * plane_bytes / HBM_BYTES_PER_S * 1e6}
            us = traced.get(part)
            print(f"  {name}'s {part} pass: traced " + (f"{us:.2f} us" if us is not None else "not measured")
                  + f", its byte bound {out[name]['pass_bound_us'][part]:.2f} us ({n_planes} arrays of "
                  f"{plane_bytes / 1e6:.2f} MB)", flush=True)
        print(f"  {name} at {h} px, {planes} planes: {out[name]['ms']:.4f} ms (traced {traced}; plain "
              f"{out[name]['plain_ms']:.4f}, library {out[name]['library_ms']:.4f}, bound {bound_ms:.4f} by "
              f"{bound_by} with 3xTF32 products, {bound_f32_ms:.4f} in float32 FMA)", flush=True)
    return out


def _traced_chain_us(fn, reps: int = 20) -> dict:
    """Device time (us) of one call of ``fn``, a tiled kernel's chain of
    launches, from a ``torch.profiler`` trace of ``reps`` calls: the sum over
    its launches, and the share of each part: the products
    (``product_kernel``), K1's one-pass blur (``blur_kernel``) and K2's
    one-pass adjoint blur (``adjoint_kernel``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {"product": 0.0, "blur": 0.0, "adjoint": 0.0}
    n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "tiled::" in e.name:
            part = next((p for p in parts if f"{p}_kernel" in e.name), None)
            if part is None:
                raise SystemExit(f"a tiled launch of no known part: {e.name}")
            parts[part] += e.time_range.elapsed_us()
            n += 1
    if not n:
        return {"total": None, "note": "not measured (no device event in the trace)"}
    return {"total": sum(parts.values()) / reps, **{k: v / reps for k, v in parts.items()}, "launches": n / reps}


def check_checkpoint(path: str) -> dict:
    """Every tensor a run saved is finite; returns the payload."""
    import torch

    payload = torch.load(path, map_location="cpu", weights_only=True)

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            if obj.is_floating_point() and not bool(torch.isfinite(obj).all()):
                raise SystemExit(f"non-finite tensor in {path}")
        elif isinstance(obj, dict):
            for v in obj.values():
                walk(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)

    walk(payload)
    return payload


def _agree(what: str, m_gpu: dict, m_cpu: dict, losses, sds) -> None:
    """Losses to 1e-3 relative and updated parameters to 1e-4 absolute (an
    update at lr 0.01 is ~1e-3; cuDNN and the CPU sum in other orders)."""
    for k in losses:
        if not abs(m_gpu[k] - m_cpu[k]) <= 1e-3 * max(1.0, abs(m_cpu[k])):
            raise SystemExit(f"{what}: card and CPU disagree on {k}: {m_gpu[k]} vs {m_cpu[k]}")
    worst = max(
        float((a[k].cpu().float() - b[k].float()).abs().max())
        for a, b in sds
        for k in b
        if b[k].is_floating_point()
    )
    print(f"  card vs CPU, one {what}: loss_ce {m_gpu['loss_ce']:.6f} vs {m_cpu['loss_ce']:.6f}; "
          f"max |param diff| = {worst:.3e} (tolerance 1e-4)", flush=True)
    if not worst <= 1e-4:
        raise SystemExit(f"{what}: card and CPU parameters disagree after one step: {worst}")


def step_agreement() -> None:
    """Phase 6: one full-width alternated step and one victim step on the
    card (kernels) and on the CPU (plain versions), each from the same
    weights and draws."""
    import torch

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.train import (
        TrainState,
        draw_alternated,
        draw_victim,
        freeze,
        make_alternated_train_step,
        make_victim_train_step,
        multistep_lr,
    )

    cfg = apply_dataset_preset(Config())
    torch.manual_seed(1)
    weights = [get_classifier(cfg), get_generator(cfg), get_classifier(cfg), get_frequency_detector(cfg)]
    gen = torch.Generator().manual_seed(2)
    x = torch.rand((16, 3, 32, 32), generator=gen) * 2 - 1
    y = torch.arange(16) % 4  # a quarter target-class rows
    poisoned = torch.arange(16) % 3 == 0  # target-class rows and others
    draws = draw_alternated(cfg, 16, gen, "cpu")
    vdraws = draw_victim(cfg, 16, gen, "cpu")
    results, vresults = {}, {}
    for dev in ("cuda", "cpu"):
        C, G, cm, nf = (copy.deepcopy(m).to(dev) for m in weights)
        sched = multistep_lr(0.01, (100,), 0.1, 10)
        stateC, stateG = TrainState(C, sched), TrainState(G, sched)
        step = make_alternated_train_step(cfg, C, G)
        m = step(stateC, stateG, freeze(cm), freeze(nf), (x.to(dev), y.to(dev)), draws=_to(draws, dev))
        results[dev] = ({k: float(v) for k, v in m.items()}, C.state_dict(), G.state_dict())

        C, G = (copy.deepcopy(m).to(dev) for m in weights[:2])
        stateC = TrainState(C, sched)
        step = make_victim_train_step(cfg, C, freeze(G))
        m = step(stateC, (x.to(dev), y.to(dev), poisoned.to(dev)), draws=_to(vdraws, dev))
        vresults[dev] = ({k: float(v) for k, v in m.items()}, C.state_dict())
    (m_gpu, c_gpu, g_gpu), (m_cpu, c_cpu, g_cpu) = results["cuda"], results["cpu"]
    _agree("alternated step", m_gpu, m_cpu, ("loss_ce", "loss_l2", "clean_model_loss", "loss_grad_l2"),
           ((c_gpu, c_cpu), (g_gpu, g_cpu)))
    (m_gpu, c_gpu), (m_cpu, c_cpu) = vresults["cuda"], vresults["cpu"]
    _agree("victim step", m_gpu, m_cpu, ("loss_ce",), ((c_gpu, c_cpu),))


def large_step_agreement() -> None:
    """Phase 6 above 64 px: one alternated step at 96 px (ResNet18, UNet nf
    64, bs 4, celeba's 8 classes) on the card, where the tiled K1/K2 run
    inside the step, against the same step on the CPU (the plain versions),
    from the same weights and draws."""
    import torch

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.ops import trigger_kernels as tk
    from combat_tpu_torch.train import TrainState, draw_alternated, freeze, make_alternated_train_step, multistep_lr

    h, n = 96, 4
    cfg = apply_dataset_preset(Config(dataset="celeba")).replace(input_height=h, input_width=h, bs=n)
    torch.manual_seed(7)
    weights = [get_classifier(cfg), get_generator(cfg), get_classifier(cfg), get_frequency_detector(cfg)]
    gen = torch.Generator().manual_seed(8)
    x = torch.rand((n, 3, h, h), generator=gen) * 2 - 1
    y = torch.tensor([0, 0, 1, 2])  # target-class rows and others
    draws = draw_alternated(cfg, n, gen, "cpu")
    results = {}
    for dev in ("cuda", "cpu"):
        C, G, cm, nf = (copy.deepcopy(m).to(dev) for m in weights)
        sched = multistep_lr(0.01, (100,), 0.1, 10)
        stateC, stateG = TrainState(C, sched), TrainState(G, sched)
        before = dict(tk.LAUNCHES)
        m = make_alternated_train_step(cfg, C, G)(stateC, stateG, freeze(cm), freeze(nf), (x.to(dev), y.to(dev)),
                                                  draws=_to(draws, dev))
        results[dev] = ({k: float(v) for k, v in m.items()}, C.state_dict(), G.state_dict())
        if dev == "cuda" and {k: tk.LAUNCHES[k] - b for k, b in before.items()} != {
                "fused_trigger_fwd": 2, "fused_trigger_bwd": 1, "low_freq": 0}:
            raise SystemExit("the 96 px step did not launch the tiled K1 twice and K2 once")
    (m_gpu, c_gpu, g_gpu), (m_cpu, c_cpu, g_cpu) = results["cuda"], results["cpu"]
    _agree("alternated step at 96 px", m_gpu, m_cpu, ("loss_ce", "loss_l2", "clean_model_loss"),
           ((c_gpu, c_cpu), (g_gpu, g_cpu)))


def zoo_step_agreement() -> None:
    """Phase 6, the rest of the registry: one alternated step at full width
    (bs 16) with DenseNet121 as C and the clean model and the
    dropout-ensemble detector, on the card and on the CPU, from the same
    weights, draws and detector masks.  (MobileNetV2's step is too
    ill-conditioned at bs 16 for phase 6's 1e-4: on the CPU alone an input
    noise of 1e-6 moves its stem conv by 3.2e-4; DenseNet121's by 6.1e-5,
    PreActResNet18's by 3.2e-5; ``scripts/step_conditioning.py``.)"""
    import torch

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.train import TrainState, draw_alternated, freeze, make_alternated_train_step, multistep_lr

    cfg = apply_dataset_preset(Config(model="densenet121", F_model="original_dropout_ensemble"))
    torch.manual_seed(11)
    weights = [get_classifier(cfg), get_generator(cfg), get_classifier(cfg), get_frequency_detector(cfg)]
    gen = torch.Generator().manual_seed(12)
    x = torch.rand((16, 3, 32, 32), generator=gen) * 2 - 1
    y = torch.arange(16) % 4
    draws = draw_alternated(cfg, 16, gen, "cpu", freeze(copy.deepcopy(weights[3])))
    if draws.drop_F is None or len(draws.drop_F) != 9:
        raise SystemExit("the ensemble detector's masks were not drawn")
    results = {}
    for dev in ("cuda", "cpu"):
        C, G, cm, nf = (copy.deepcopy(m).to(dev) for m in weights)
        sched = multistep_lr(0.01, (100,), 0.1, 10)
        stateC, stateG = TrainState(C, sched), TrainState(G, sched)
        m = make_alternated_train_step(cfg, C, G)(stateC, stateG, freeze(cm), freeze(nf), (x.to(dev), y.to(dev)),
                                                  draws=_to(draws, dev))
        results[dev] = ({k: float(v) for k, v in m.items()}, C.state_dict(), G.state_dict())
    (m_gpu, c_gpu, g_gpu), (m_cpu, c_cpu, g_cpu) = results["cuda"], results["cpu"]
    if m_gpu["F_correct"] != m_cpu["F_correct"]:
        raise SystemExit(f"F_correct of the ensemble detector: card {m_gpu['F_correct']}, CPU {m_cpu['F_correct']}")
    _agree("DenseNet121 alternated step with the dropout-ensemble detector", m_gpu, m_cpu,
           ("loss_ce", "loss_l2", "clean_model_loss", "loss_grad_l2"), ((c_gpu, c_cpu), (g_gpu, g_cpu)))


def zoo_extra_step_agreement() -> None:
    """Phase 6, the extended zoo: one alternated step at full width with
    ``ZOO_EXTRA_AGREEMENT`` as C and the clean model on the card and on the
    CPU, from the same weights and draws: DPN26 at bs 128, its 32-group
    convolutions and the dense path's channel slices and concatenation.
    The families with channel shuffles are too ill-conditioned for phase
    6's 1e-4: on the CPU alone an input noise of 1e-6 moves ShuffleNetV2's
    stem conv by 4.2e-4 at bs 16 and 1.5e-4 at bs 128, ShuffleNetG2's by
    3.4e-3 at bs 16 and 1.8e-3 at bs 64; DPN26's by 1.3e-4 at bs 16 and
    4.6e-5 at bs 128, where BatchNorm's statistics over 128 rows move less
    with the input (``scripts/step_conditioning.py``).  The shuffles run on
    the card in phases 5za-5zc and 7."""
    import torch

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.train import TrainState, draw_alternated, freeze, make_alternated_train_step, multistep_lr

    name, n = ZOO_EXTRA_AGREEMENT
    cfg = apply_dataset_preset(Config(model=name))
    torch.manual_seed(11)
    weights = [get_classifier(cfg), get_generator(cfg), get_classifier(cfg), get_frequency_detector(cfg)]
    gen = torch.Generator().manual_seed(12)
    x = torch.rand((n, 3, 32, 32), generator=gen) * 2 - 1
    y = torch.arange(n) % 4
    draws = draw_alternated(cfg, n, gen, "cpu")
    results = {}
    for dev in ("cuda", "cpu"):
        C, G, cm, nf = (copy.deepcopy(m).to(dev) for m in weights)
        sched = multistep_lr(0.01, (100,), 0.1, 10)
        stateC, stateG = TrainState(C, sched), TrainState(G, sched)
        m = make_alternated_train_step(cfg, C, G)(stateC, stateG, freeze(cm), freeze(nf), (x.to(dev), y.to(dev)),
                                                  draws=_to(draws, dev))
        results[dev] = ({k: float(v) for k, v in m.items()}, C.state_dict(), G.state_dict())
    (m_gpu, c_gpu, g_gpu), (m_cpu, c_cpu, g_cpu) = results["cuda"], results["cpu"]
    _agree(f"{name} alternated step (bs {n})", m_gpu, m_cpu, ("loss_ce", "loss_l2", "clean_model_loss", "loss_grad_l2"),
           ((c_gpu, c_cpu), (g_gpu, g_cpu)))


def efficientnet_detector_step_agreement() -> None:
    """Phase 6: one train step of an EfficientNetB0 detector (``--F_model
    efficientnetb0``, bs 128, Adam) on the card and on the CPU, from the same
    weights, corruption draws and dropout masks (drawn once on the CPU, one
    keep per row and channel).  Adam's first update is lr x g / (|g| +
    1e-8), a full step of either sign wherever |g| is well above 1e-8, so a
    gradient near 1e-8 moves its parameter with the rounding of its sum (a
    CPU test of the port against the JAX step found one at 2.6e-8 in
    float64): the card is held to the CPU on the gradients the step leaves
    in ``.grad`` (1e-4 absolute), the loss (1e-3 relative), the counts and
    the running statistics (1e-4 relative)."""
    import torch

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.defenses.frequency import draw_detector, make_detector_train_step
    from combat_tpu_torch.defenses.frequency_train import detector_optimizer
    from combat_tpu_torch.models import get_frequency_detector

    cfg = apply_dataset_preset(Config(F_model="efficientnetb0"))
    torch.manual_seed(19)
    weights = get_frequency_detector(cfg).train()
    gen = torch.Generator().manual_seed(20)
    x01 = torch.rand((BS, C, H, H), generator=gen)
    draws = draw_detector(weights, x01, gen)
    if draws.drop is None or len(draws.drop) != 16 or tuple(draws.drop[0].shape) != (2 * BS, 16, 1, 1):
        raise SystemExit("the EfficientNet detector's broadcast dropout masks were not drawn")
    results = {}
    for dev in ("cuda", "cpu"):
        netF = copy.deepcopy(weights).to(dev)
        m = make_detector_train_step(netF)(detector_optimizer(cfg, netF.parameters()), (x01.to(dev), None),
                                           draws=_to(draws, dev))
        grads = {k: p.grad.detach().cpu() for k, p in netF.named_parameters()}
        results[dev] = ({k: float(v) for k, v in m.items()}, netF.state_dict(), grads)
    (m_gpu, sd_gpu, g_gpu), (m_cpu, sd_cpu, g_cpu) = results["cuda"], results["cpu"]
    if m_gpu["correct"] != m_cpu["correct"]:
        raise SystemExit(f"EfficientNet detector step: card counts {m_gpu['correct']} correct, CPU {m_cpu['correct']}")
    if not abs(m_gpu["loss_ce"] - m_cpu["loss_ce"]) <= 1e-3 * max(1.0, abs(m_cpu["loss_ce"])):
        raise SystemExit(f"EfficientNet detector step: card and CPU losses {m_gpu['loss_ce']}, {m_cpu['loss_ce']}")
    stats = ("running_mean", "running_var")
    worst_stat = max(float(((sd_gpu[k].cpu() - v).abs() / v.abs().clamp_min(1.0)).max()) for k, v in sd_cpu.items()
                     if k.endswith(stats))
    worst_grad = max(float((g_gpu[k] - v).abs().max()) for k, v in g_cpu.items())
    print(f"  card vs CPU, one EfficientNet detector step: loss_ce {m_gpu['loss_ce']:.6f} vs {m_cpu['loss_ce']:.6f}; "
          f"max |grad diff| = {worst_grad:.3e} (tolerance 1e-4), max relative |running statistics diff| = "
          f"{worst_stat:.3e} (tolerance 1e-4)", flush=True)
    if not (worst_grad <= 1e-4 and worst_stat <= 1e-4):
        raise SystemExit("EfficientNet detector step: card and CPU gradients or statistics disagree")


def variant_step_agreement() -> None:
    """Phase 6, the variants: one full-width input-aware step and one
    multilabel step (bs 32) on the card (K1/K2) and on the CPU (plain
    versions), each from the same weights and draws."""
    import torch

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.train import TrainState, draw_alternated, draw_inputaware, freeze, multistep_lr
    from combat_tpu_torch.train import variants

    cfg = apply_dataset_preset(Config())
    n = 32
    for variant, kind, draw in (("inputaware", "unet", draw_inputaware), ("multilabel", "cunet", draw_alternated)):
        torch.manual_seed(5)
        weights = [get_classifier(cfg), get_generator(cfg, kind), get_classifier(cfg), get_frequency_detector(cfg)]
        gen = torch.Generator().manual_seed(6)
        x = torch.rand((n, 3, 32, 32), generator=gen) * 2 - 1
        x2 = torch.rand((n, 3, 32, 32), generator=gen) * 2 - 1
        y = torch.randint(0, 10, (n,), generator=gen)
        batch = (x, y, x2) if variant == "inputaware" else (x, y)
        draws = draw(cfg, n, gen, "cpu")
        results = {}
        for dev in ("cuda", "cpu"):
            C, G, cm, nf = (copy.deepcopy(m).to(dev) for m in weights)
            sched = multistep_lr(0.01, (100,), 0.1, 10)
            stateC, stateG = TrainState(C, sched), TrainState(G, sched)
            step = getattr(variants, f"make_{variant}_train_step")(cfg, C, G)
            m = step(stateC, stateG, freeze(cm), freeze(nf), tuple(t.to(dev) for t in batch), draws=_to(draws, dev))
            results[dev] = ({k: float(v) for k, v in m.items()}, C.state_dict(), G.state_dict())
        (m_gpu, c_gpu, g_gpu), (m_cpu, c_cpu, g_cpu) = results["cuda"], results["cpu"]
        _agree(f"{variant} step", m_gpu, m_cpu, ("loss_ce", "loss_l2", "clean_model_loss"),
               ((c_gpu, c_cpu), (g_gpu, g_cpu)))


def detector_step_agreement() -> None:
    """Phase 6, the defenses: one train step of the ``original`` frequency
    detector at full size (bs 128, Adadelta) on the card and on the CPU,
    from the same weights, corruption draws and dropout masks; parameters to
    phase 6's 1e-4, BatchNorm's running statistics to 1e-4 relative (its
    variances reach hundreds on DCT coefficients), the counts equal."""
    import torch

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.defenses.frequency import draw_detector, make_detector_train_step
    from combat_tpu_torch.defenses.frequency_train import detector_optimizer
    from combat_tpu_torch.models import get_frequency_detector

    cfg = apply_dataset_preset(Config())
    torch.manual_seed(13)
    weights = get_frequency_detector(cfg).train()
    gen = torch.Generator().manual_seed(14)
    x01 = torch.rand((BS, C, H, H), generator=gen)
    draws = draw_detector(weights, x01, gen)
    if draws.drop is None:
        raise SystemExit("the original detector's train-mode dropout masks were not drawn")
    results = {}
    for dev in ("cuda", "cpu"):
        netF = copy.deepcopy(weights).to(dev)
        m = make_detector_train_step(netF)(detector_optimizer(cfg, netF.parameters()), (x01.to(dev), None),
                                           draws=_to(draws, dev))
        results[dev] = ({k: float(v) for k, v in m.items()}, netF.state_dict())
    (m_gpu, sd_gpu), (m_cpu, sd_cpu) = results["cuda"], results["cpu"]
    if m_gpu["correct"] != m_cpu["correct"]:
        raise SystemExit(f"detector step: card counts {m_gpu['correct']} correct, CPU {m_cpu['correct']}")
    stats = ("running_mean", "running_var")
    worst = max(float(((sd_gpu[k].cpu() - v).abs() / v.abs().clamp_min(1.0)).max()) for k, v in sd_cpu.items()
                if k.endswith(stats))
    print(f"  card vs CPU, one detector step: max relative |running statistics diff| = {worst:.3e} "
          "(tolerance 1e-4)", flush=True)
    if not worst <= 1e-4:
        raise SystemExit(f"detector step: card and CPU BatchNorm statistics disagree: {worst}")
    _agree("detector step", m_gpu, m_cpu, ("loss_ce",),
           (({k: v for k, v in sd_gpu.items() if not k.endswith(stats)}, {k: v for k, v in sd_cpu.items()
                                                                          if not k.endswith(stats)}),))


# Phase 6's extended-zoo step: (--model, batch size); scripts/step_conditioning.py
ZOO_EXTRA_AGREEMENT = ("dpn26", 128)

# Phase 6's bfloat16 steps run on these seeds (weights, batch and draws): a
# loss, or a tensor of a few numbers, is one draw of the rounding noise, and
# six steps show whether a ratio stays high or was one draw.
BF16_SEEDS = (1, 2, 3, 4, 5, 6)


def bf16_step_agreement() -> None:
    """Phase 6 in bfloat16: on each of ``BF16_SEEDS``, one full-width
    cifar10 alternated step and one victim step (bs 16) on the card in
    float32 and in bfloat16 and on the CPU in bfloat16, from the same
    weights and draws, held by the gap criterion of
    ``combat_tpu_torch/utils/gap.py``: the CPU's bfloat16 step is the
    reference low-precision run and the card's float32 step its float32
    run.  Each seed's counts, parameters and statistics are held alone; the
    losses of all seeds together.  Every failure is printed before the
    phase fails."""
    import torch

    from combat_tpu_torch.cli.common import setup_device
    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator, set_compute_dtype
    from combat_tpu_torch.train import (
        TrainState,
        draw_alternated,
        draw_victim,
        freeze,
        make_alternated_train_step,
        make_victim_train_step,
        multistep_lr,
    )
    from combat_tpu_torch.utils import gap

    cfg = apply_dataset_preset(Config(compute_dtype="bfloat16"))
    setup_device(cfg)  # TF32 off; the bfloat16 products reduce in float32
    sched = multistep_lr(0.01, (100,), 0.1, 10)
    steps = {"alternated step": ("loss_ce", "loss_l2", "clean_model_loss", "loss_grad_l2"), "victim step": ("loss_ce",)}
    failures, losses = [], {what: ([], [], []) for what in steps}
    for seed in BF16_SEEDS:
        torch.manual_seed(seed)
        weights = [get_classifier(cfg), get_generator(cfg), get_classifier(cfg), get_frequency_detector(cfg)]
        gen = torch.Generator().manual_seed(100 + seed)
        x = torch.rand((16, 3, 32, 32), generator=gen) * 2 - 1
        y = torch.arange(16) % 4
        poisoned = torch.arange(16) % 3 == 0
        draws = draw_alternated(cfg, 16, gen, "cpu")
        vdraws = draw_victim(cfg, 16, gen, "cpu")
        runs = {what: {} for what in steps}
        for name, dev, dtype in (("card f32", "cuda", None), ("card bf16", "cuda", torch.bfloat16),
                                 ("cpu bf16", "cpu", torch.bfloat16)):
            C, G, cm, nf = (set_compute_dtype(copy.deepcopy(m), dtype).to(dev) for m in weights)
            stateC, stateG = TrainState(C, sched), TrainState(G, sched)
            m = make_alternated_train_step(cfg, C, G)(stateC, stateG, freeze(cm), freeze(nf),
                                                      (x.to(dev), y.to(dev)), draws=_to(draws, dev))
            runs["alternated step"][name] = ({k: float(v) for k, v in m.items()}, (C.state_dict(), G.state_dict()))
            C, G = (set_compute_dtype(copy.deepcopy(m), dtype).to(dev) for m in weights[:2])
            stateC = TrainState(C, sched)
            m = make_victim_train_step(cfg, C, freeze(G))(stateC, (x.to(dev), y.to(dev), poisoned.to(dev)),
                                                          draws=_to(vdraws, dev))
            runs["victim step"][name] = ({k: float(v) for k, v in m.items()}, (C.state_dict(),))
        for what, keys in steps.items():
            (m32, sd32), (m_lo, sd_lo), (m_cpu, sd_cpu) = (runs[what][n] for n in ("card f32", "card bf16", "cpu bf16"))
            models = [("CG"[i], lo, f32, cpu, f32) for i, (lo, f32, cpu) in enumerate(zip(sd_lo, sd32, sd_cpu))]
            failures += [f"seed {seed} {f}" for f in gap.count_failures(what, m_lo, m_cpu,
                                                                          [k for k in m_cpu if k not in keys])]
            failures += [f"seed {seed} {what} {f}" for f in gap.state_failures(models, f32_tol=1e-4)]
            for vector, m in zip(losses[what], (m_lo, m_cpu, m32)):
                vector.extend(m[k] for k in keys)
            flat = [torch.cat([sd[k].detach().cpu().double().reshape(-1) for sd in sds for k in sd
                               if sd[k].is_floating_point()]) for sds in (sd_lo, sd32, sd_cpu)]
            g, a, b, _ = gap.ratios(flat[0], flat[1], flat[2], flat[1])
            tensors = [(f"{name}.{k}", cpu[k].numel(), *gap.ratios(lo[k], f32[k], cpu[k], f32[k])[1:3])
                       for name, lo, f32, cpu, _ in models for k in cpu
                       if cpu[k].is_floating_point() and gap.rms(cpu[k].double() - f32[k].cpu().double()) > 0.0]
            big = [t for t in tensors if t[1] >= gap.MIN_NUMEL]
            worst_a, worst_b = max(big, key=lambda t: t[2]), max(big, key=lambda t: t[3])
            print(f"  card vs CPU, one bfloat16 {what}, seed {seed}: loss_ce {m_lo['loss_ce']:.6f} vs "
                  f"{m_cpu['loss_ce']:.6f} (float32 {m32['loss_ce']:.6f}); every tensor: gap {g:.3e}, a = c {a:.3f}, "
                  f"b {b:.3f}; worst of {gap.MIN_NUMEL} or more numbers a {worst_a[2]:.3f} ({worst_a[0]}), b "
                  f"{worst_b[3]:.3f} ({worst_b[0]}); smaller (a, b): "
                  + ", ".join(f"{k} {ra:.2f} {rb:.2f}" for k, n, ra, rb in tensors if n < gap.MIN_NUMEL), flush=True)
    for what, (card, cpu, f32) in losses.items():
        g, b = gap.loss_ratio(card, cpu, f32)
        print(f"  card vs CPU, the bfloat16 {what}s' {len(card)} losses over seeds {BF16_SEEDS}: gap {g:.3e}, "
              f"b {b:.3f} (<= {gap.BETA})", flush=True)
        failure = gap.loss_failure(f"{what} losses", card, cpu, f32)
        failures += [failure] if failure else []
    if failures:
        raise SystemExit("\n".join(failures))


# Phase 7's trigger routes: (--pallas_trigger, --pallas_lowfreq).
ROUTES = {"pallas_trigger": (True, False), "lowfreq_kernel": (False, True), "aten": (False, False)}


def _ms_per_step(run, warm: int = 2, iters: int = 5) -> float:
    """Host-clock ms per call of ``run`` over ``iters`` synchronised calls,
    after ``warm`` warm-up calls (cuDNN picks its algorithms there).  A
    step's metrics, when ``run`` returns them, must hold a finite loss."""
    import torch

    for _ in range(warm):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        m = run()
    torch.cuda.synchronize()
    if isinstance(m, dict) and not bool(torch.isfinite(m["loss_ce"])):
        raise SystemExit("non-finite loss in the steady-state steps")
    return (time.perf_counter() - t0) * 1e3 / iters


def step_times() -> dict:
    """Phase 7: the steady-state steps in float32, then the same steps in
    bfloat16 (``--compute_dtype``), in one run; every row names its dtype;
    then the float32 alternated steps with and without ``--remat step``."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        out.update(_step_times(dtype))
    out.update(remat_step_times())
    return out


def remat_step_times() -> dict:
    """Phase 7, ``--remat step`` against ``none``: the float32 alternated
    step on the K1/K2 route at cifar10 (bs 128) and imagenet10 (224 px, bs
    32), each with its ms and ``max_memory_allocated`` over its warm-up and
    timed steps, beside the memory resident before them."""
    import torch

    from combat_tpu_torch.cli.common import setup_device
    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.train import TrainState, freeze, make_alternated_train_step, multistep_lr

    out = {}
    sched = multistep_lr(0.01, (100,), 0.1, 10)
    for dataset in ("cifar10", "imagenet10"):
        data = apply_dataset_preset(Config(dataset=dataset))
        dev = setup_device(data)
        n, h = (BS if dataset == "cifar10" else data.bs), data.input_height
        gen = torch.Generator(device=dev).manual_seed(5)
        x = torch.rand((n, C, h, h), generator=gen, device=dev) * 2 - 1
        y = torch.randint(0, data.num_classes, (n,), generator=gen, device=dev)
        for remat in ("none", "step"):
            cfg = data.replace(remat=remat)
            torch.manual_seed(4)
            C_, G = get_classifier(cfg).to(dev), get_generator(cfg).to(dev)
            cm, nf = freeze(get_classifier(cfg).to(dev)), freeze(get_frequency_detector(cfg).to(dev))
            stateC, stateG = TrainState(C_, sched), TrainState(G, sched)
            step = make_alternated_train_step(cfg, C_, G)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            ms = _ms_per_step(lambda: step(stateC, stateG, cm, nf, (x, y), gen), iters=3 if h > 32 else 5)
            peak = torch.cuda.max_memory_allocated()
            key = f"float32/remat {remat}/{dataset}"
            out[key] = {"ms_per_step": ms, "images_per_s": n * 1e3 / ms, "max_memory_allocated_bytes": peak,
                        "resident_before_bytes": resident}
            print(f"  step {key}: {ms:.3f} ms ({n * 1e3 / ms:.0f} img/s), max_memory_allocated "
                  f"{peak / 2**30:.3f} GiB ({resident / 2**30:.3f} GiB resident before)", flush=True)
            del C_, G, cm, nf, stateC, stateG, step
    return out


def _step_times(dtype: str) -> dict:
    """ms per step at full width, bs 128, in ``dtype``: the alternated step
    on each trigger route and in both metric modes, the victim step on the
    K1 and ATen routes, and the victim step's parts, each timed alone."""
    import torch

    from combat_tpu_torch.cli.common import setup_device
    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.train import (
        TrainState,
        cross_entropy,
        draw_victim,
        freeze,
        make_alternated_train_step,
        make_victim_train_step,
        multistep_lr,
    )
    from combat_tpu_torch.train.steps import _aug_fn, _trigger_fn

    base = apply_dataset_preset(Config(compute_dtype=dtype))
    dev = setup_device(base)  # TF32 off; bfloat16 products reduce in float32
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((BS, C, H, H), generator=gen, device=dev) * 2 - 1
    y = torch.randint(0, 10, (BS,), generator=gen, device=dev)
    poisoned = torch.rand((BS,), generator=gen, device=dev) < 0.05  # pc 0.5 of the target class's tenth
    sched = multistep_lr(0.01, (100,), 0.1, 10)
    out = {}

    def record(key, ms, bs=BS):
        out[f"{dtype}/{key}"] = {"ms_per_step": ms, "images_per_s": bs * 1e3 / ms}
        print(f"  step {dtype} {key}: {ms:.3f} ms ({bs * 1e3 / ms:.0f} img/s)", flush=True)

    for route, (fused, lowfreq) in ROUTES.items():
        for mode in ("full", "loss_only"):
            cfg = base.replace(pallas_trigger=fused, pallas_lowfreq=lowfreq, train_metrics=mode)
            torch.manual_seed(4)
            C_, G = get_classifier(cfg).to(dev), get_generator(cfg).to(dev)
            cm, nf = freeze(get_classifier(cfg).to(dev)), freeze(get_frequency_detector(cfg).to(dev))
            stateC, stateG = TrainState(C_, sched), TrainState(G, sched)
            step = make_alternated_train_step(cfg, C_, G)
            record(f"{route}/{mode}", _ms_per_step(lambda: step(stateC, stateG, cm, nf, (x, y), gen)))
    for route in ("pallas_trigger", "aten"):
        fused, lowfreq = ROUTES[route]
        cfg = base.replace(pallas_trigger=fused, pallas_lowfreq=lowfreq)
        torch.manual_seed(4)
        C_, G = get_classifier(cfg).to(dev), freeze(get_generator(cfg).to(dev))
        stateC = TrainState(C_, sched)
        vstep = make_victim_train_step(cfg, C_, G)
        record(f"victim/{route}", _ms_per_step(lambda: vstep(stateC, (x, y, poisoned), gen)))
    record("victim parts/G forward", _ms_per_step(lambda: _no_grad(G, x)))
    noise = _no_grad(G, x)
    draws = draw_victim(cfg, BS, gen, dev)
    for route in ("pallas_trigger", "aten"):
        trig = _trigger_fn(cfg.replace(pallas_trigger=ROUTES[route][0]))
        record(f"victim parts/trigger {route}", _ms_per_step(lambda: _no_grad(trig, x, noise, sigma_draw=draws.sigma)))
    record("victim parts/augment", _ms_per_step(lambda: _no_grad(_aug_fn(cfg), x, draws.aug)))

    def c_update():
        C_.train()
        stateC.zero_grad()
        cross_entropy(C_(x), y).backward()
        stateC.apply_gradients()

    record("victim parts/C forward, backward, SGD", _ms_per_step(c_update))
    out.update(variant_step_times(base, x, y, gen, sched, record))
    # bfloat16: one warm-up and one timed step a classifier, to keep the run's time
    zoo_step_times(base, x, y, poisoned, gen, sched, record, *((2, 3) if dtype == "float32" else (1, 1)))
    out.update(large_step_times(base, sched, record))
    if dtype == "float32":  # the variants at imagenet10 (224 px, bs 32, the tiled kernels)
        data = apply_dataset_preset(Config(dataset="imagenet10"))
        gen = torch.Generator(device=dev).manual_seed(5)
        x = torch.rand((data.bs, C, data.input_height, data.input_height), generator=gen, device=dev) * 2 - 1
        y = torch.randint(0, data.num_classes, (data.bs,), generator=gen, device=dev)
        out.update(variant_step_times(data, x, y, gen, sched, record, key="imagenet10/variant", iters=3))
    return out


def defense_times() -> dict:
    """Phase 7, the defenses, in float32 and in bfloat16, then the hoisted
    fine-pruning sweep against a per-mask sweep (float32)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        out.update(_defense_times(dtype))
    out.update(fine_pruning_speedup())
    return out


def _defense_times(dtype: str) -> dict:
    """ms at full width in ``dtype`` (PreActResNet18, UNet nf 64, cifar10):
    fine-pruning's trunk pass on a batch of 256 (G, K1, C's trunk on the
    clean and the triggered batch) and its heads per mask (all 513 masks on
    that batch's two maps, in chunks of 57, divided by 513); one STRIP
    round (100 backgrounds x 100 overlays, 10,000 forwards); one Neural
    Cleanse step at bs 64; one train step of the ``original`` detector at bs
    128 (Adadelta)."""
    import torch

    from combat_tpu_torch.cli.common import setup_device
    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.defenses.fine_pruning import pruning_masks
    from combat_tpu_torch.defenses.frequency import make_detector_train_step
    from combat_tpu_torch.defenses.frequency_train import detector_optimizer
    from combat_tpu_torch.defenses.neural_cleanse import make_nc_step
    from combat_tpu_torch.defenses.strip import superimpose_entropy
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.train import freeze
    from combat_tpu_torch.train.steps import _trigger_fn

    cfg = apply_dataset_preset(Config(compute_dtype=dtype))
    dev = setup_device(cfg)
    gen = torch.Generator(device=dev).manual_seed(15)
    torch.manual_seed(16)
    Cv, G = freeze(get_classifier(cfg).to(dev)), freeze(get_generator(cfg).to(dev))
    out = {}

    def record(key, ms, what):
        out[f"{dtype}/{key}"] = {"ms": ms, "what": what}
        print(f"  defense {dtype} {key}: {ms:.4f} ms ({what})", flush=True)

    x = torch.rand((256, C, H, H), generator=gen, device=dev) * 2 - 1
    trig, sigma = _trigger_fn(cfg), torch.tensor(0.5, device=dev)
    with torch.no_grad():
        def trunk_pass():
            return Cv.trunk(x), Cv.trunk(trig(x, G(x), sigma_draw=sigma))

        record("fine-pruning/trunk pass", _ms_per_step(trunk_pass), "a batch of 256: G, K1, two trunks")
        maps = trunk_pass()
        masks = pruning_masks(torch.rand(512, generator=gen, device=dev))
        heads = _ms_per_step(lambda: [Cv.head(mp, masks[k:k + 57]).argmax(-1) for k in range(0, 513, 57)
                                      for mp in maps])
        record("fine-pruning/heads per mask", heads / 513, "a batch of 256, both maps, chunks of 57")
        bg = torch.rand((100, C, H, H), generator=gen, device=dev) * 2 - 1
        pool = torch.rand((1000, C, H, H), generator=gen, device=dev) * 2 - 1
        record("STRIP round", _ms_per_step(lambda: superimpose_entropy(Cv, bg, pool, 100, generator=gen), warm=1,
                                           iters=3), "100 x 100 superimposed forwards")
    params = {"mask_tanh": torch.ones((H, H), device=dev, requires_grad=True),
              "pattern_tanh": torch.ones((C, H, H), device=dev, requires_grad=True)}
    opt = torch.optim.Adam(params.values(), lr=0.1, betas=(0.5, 0.9))
    nc_step, _ = make_nc_step(cfg, Cv, 0)
    record("Neural Cleanse step", _ms_per_step(lambda: nc_step(params, opt, x[:64], 1e-3)), "bs 64, Adam")
    netF = get_frequency_detector(cfg).to(dev)
    fopt = detector_optimizer(cfg, netF.parameters())
    dstep = make_detector_train_step(netF)
    x01 = torch.rand((BS, C, H, H), generator=gen, device=dev)
    record("detector train step", _ms_per_step(lambda: dstep(fopt, (x01, None), gen)),
           "bs 128 + 128 corrupted, Adadelta")
    return out


def fine_pruning_speedup() -> dict:
    """The hoisted sweep (``defenses/fine_pruning.py``: G, K1 and C's trunk
    once a batch, then the heads per mask) against a per-mask sweep of the
    JAX package's form (G, the trigger and both C forwards with the mask,
    for every mask), on one small split (32 images, one batch), float32,
    timed once each after a warm-up; their accuracies must agree."""
    import torch

    from combat_tpu_torch.attack.triggers import create_targets_bd
    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.defenses.fine_pruning import channel_activations, pruning_masks, pruning_sweep
    from combat_tpu_torch.models import get_classifier, get_generator
    from combat_tpu_torch.train import freeze
    from combat_tpu_torch.train.steps import _trigger_fn

    cfg = apply_dataset_preset(Config())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(17)
    torch.manual_seed(18)
    Cv, G = freeze(get_classifier(cfg).to(dev)), freeze(get_generator(cfg).to(dev))
    n = 32
    x = torch.rand((n, C, H, H), generator=gen, device=dev) * 2 - 1
    y = torch.randint(0, 10, (n,), generator=gen, device=dev)
    sigmas = [torch.tensor(0.5, device=dev)]
    trig = _trigger_fn(cfg)

    def per_mask():
        masks = pruning_masks(channel_activations(Cv, x, bs=n))
        totals = torch.zeros((masks.shape[0], 2), device=dev)
        with torch.no_grad():
            bd = create_targets_bd(y, cfg.attack_mode, cfg.target_label, cfg.num_classes)
            for k, m in enumerate(masks):
                x_bd = trig(x, G(x), sigma_draw=sigmas[0])
                totals[k, 0] += (Cv(x, channel_mask=m).argmax(-1) == y).sum()
                totals[k, 1] += (Cv(x_bd, channel_mask=m).argmax(-1) == bd).sum()
        return totals * 100.0 / n

    times, results = {}, {}
    for name, fn in (("hoisted", lambda: pruning_sweep(cfg, Cv, G, x, y, bs=n, sigmas=sigmas)),
                     ("per mask", per_mask)):
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[name] = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
    differ = int((results["hoisted"] != results["per mask"]).any(-1).sum())
    print(f"  fine-pruning sweep of 513 masks on {n} images: hoisted {times['hoisted']:.3f} ms, per mask "
          f"{times['per mask']:.3f} ms ({times['per mask'] / times['hoisted']:.1f}x); masks whose accuracies "
          f"differ: {differ} (at most 1 image each allowed)", flush=True)
    if float((results["hoisted"] - results["per mask"]).abs().max()) > 100.0 / n + 1e-3:
        raise SystemExit("the hoisted fine-pruning sweep disagrees with the per-mask sweep")
    return {"float32/fine-pruning/hoisted vs per mask": {"images": n, "hoisted_ms": times["hoisted"],
                                                          "per_mask_ms": times["per mask"], "masks_differing": differ}}


def zoo_step_times(base, x, y, poisoned, gen, sched, record, warm=2, iters=3) -> None:
    """Phase 7, the rest of the registry: the alternated step (full
    metrics, K1/K2 route) and the victim step (K1) at bs 128 with each of
    ``ZOO_TIMED`` and ``ZOO_EXTRA_TIMED`` as C (and as the clean model), in
    ``base``'s compute dtype; ``warm`` warm-up and ``iters`` timed steps
    each."""
    import torch

    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.train import TrainState, freeze, make_alternated_train_step, make_victim_train_step

    dev = x.device
    for name in ZOO_TIMED + ZOO_EXTRA_TIMED:
        cfg = base.replace(model=name)
        torch.manual_seed(4)
        C_, G = get_classifier(cfg).to(dev), get_generator(cfg).to(dev)
        cm, nf = freeze(get_classifier(cfg).to(dev)), freeze(get_frequency_detector(cfg).to(dev))
        stateC, stateG = TrainState(C_, sched), TrainState(G, sched)
        step = make_alternated_train_step(cfg, C_, G)
        record(f"model/{name}", _ms_per_step(lambda: step(stateC, stateG, cm, nf, (x, y), gen), warm, iters))
        vstep = make_victim_train_step(cfg, C_, freeze(G))
        record(f"model/{name} victim", _ms_per_step(lambda: vstep(stateC, (x, y, poisoned), gen), warm, iters))
        del C_, G, cm, nf, stateC, stateG, step, vstep


# Phase 7's classifiers beyond the ResNets (vit at 32 px: 64 tokens; it is
# not driven at 224 px, where its 3136 tokens would need ~10 GB of float32
# attention matrices a layer at bs 32)
ZOO_TIMED = ("vgg16", "mobilenetv2", "densenet121", "vit", "vitsmall")
# and the extended zoo's trainable names (efficientnetb0's C-step stops, as in the JAX package)
ZOO_EXTRA_TIMED = ("lenet", "mobilenet", "googlenet", "dpn26", "dpn92", "senet18", "shufflenetg2", "shufflenetv2",
                   "resnext29_2x64d", "resnext29_32x4d", "pnasneta", "pnasnetb")


def large_step_times(base, sched, record) -> dict:
    """Phase 7 above 32 px, full metrics, in ``base``'s compute dtype: the
    imagenet10 alternated step (224 px, bs 32) on the K1/K2 route (the tiled
    kernels) and the ATen route, with the peak device memory of the K1/K2
    step; the imagenet10 victim step on K1; the celeba alternated step (64
    px, bs 128) on K1/K2.  224 px steps take ~1 s, so 2 warm-up and 3 timed
    steps each."""
    import torch

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.train import TrainState, freeze, make_alternated_train_step, make_victim_train_step

    dev = torch.device("cuda", 0)
    memory = {}
    for dataset, routes in (("imagenet10", ("pallas_trigger", "aten")), ("celeba", ("pallas_trigger",))):
        data = apply_dataset_preset(Config(dataset=dataset, compute_dtype=base.compute_dtype))
        n, h = data.bs if dataset == "imagenet10" else BS, data.input_height
        gen = torch.Generator(device=dev).manual_seed(5)
        x = torch.rand((n, C, h, h), generator=gen, device=dev) * 2 - 1
        y = torch.randint(0, data.num_classes, (n,), generator=gen, device=dev)
        for route in routes:
            fused, lowfreq = ROUTES[route]
            cfg = data.replace(pallas_trigger=fused, pallas_lowfreq=lowfreq)
            torch.manual_seed(4)
            C_, G = get_classifier(cfg).to(dev), get_generator(cfg).to(dev)
            cm, nf = freeze(get_classifier(cfg).to(dev)), freeze(get_frequency_detector(cfg).to(dev))
            stateC, stateG = TrainState(C_, sched), TrainState(G, sched)
            step = make_alternated_train_step(cfg, C_, G)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            ms = _ms_per_step(lambda: step(stateC, stateG, cm, nf, (x, y), gen), iters=3)
            record(f"{dataset}/{route}", ms, n)
            if dataset == "imagenet10" and route == "pallas_trigger":
                memory = {"max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                          "resident_before_bytes": resident}
                peak = memory["max_memory_allocated_bytes"] / 2**30
                print(f"  imagenet10 {base.compute_dtype} K1/K2 step: max_memory_allocated {peak:.3f} GiB "
                      f"({resident / 2**30:.3f} GiB resident before the step)", flush=True)
            del C_, G, cm, nf, stateC, stateG, step
        if dataset == "imagenet10":
            cfg = data.replace(pallas_trigger=True)
            torch.manual_seed(4)
            C_, G = get_classifier(cfg).to(dev), freeze(get_generator(cfg).to(dev))
            stateC = TrainState(C_, sched)
            vstep = make_victim_train_step(cfg, C_, G)
            poisoned = torch.arange(n, device=dev) % 10 == 0
            record("imagenet10/victim pallas_trigger", _ms_per_step(lambda: vstep(stateC, (x, y, poisoned), gen),
                                                                   iters=3), n)
            del C_, G, stateC, vstep
    return {f"{base.compute_dtype}/imagenet10/memory": memory}


def variant_step_times(cfg, x, y, gen, sched, record, key="variant", iters=5) -> dict:
    """Phase 7, the variants: each variant's train step at full width (full
    metrics) on the K1/K2 route, and the WaNet victim step, in ``cfg``'s
    compute dtype on the batch ``x, y``; 2 warm-up and ``iters`` timed steps
    each, rows named ``key/...``, with each row's peak device memory over
    them beside the memory resident before them."""
    import torch

    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.train import TrainState, freeze
    from combat_tpu_torch.train import variants

    dev, n = x.device, x.shape[0]
    x2 = torch.rand(x.shape, generator=gen, device=dev) * 2 - 1
    poisoned = torch.rand((n,), generator=gen, device=dev) < 0.05
    memory = {}

    def timed(name, run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        record(f"{key}/{name}", _ms_per_step(run, iters=iters), n)
        memory[name] = {"max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                        "resident_before_bytes": resident}
        print(f"  {key}/{name} {cfg.compute_dtype}: max_memory_allocated "
              f"{memory[name]['max_memory_allocated_bytes'] / 2**30:.3f} GiB ({resident / 2**30:.3f} GiB "
              "resident before the step)", flush=True)

    for variant, kind in (("wanet", "grid"), ("inputaware", "unet"), ("imperceptible", "unet"),
                          ("multilabel", "cunet")):
        torch.manual_seed(4)
        C_, G = get_classifier(cfg).to(dev), get_generator(cfg, kind).to(dev)
        cm, nf = freeze(get_classifier(cfg).to(dev)), freeze(get_frequency_detector(cfg).to(dev))
        stateC, stateG = TrainState(C_, sched), TrainState(G, sched)
        step = getattr(variants, f"make_{variant}_train_step")(cfg, C_, G)
        batch = (x, y, x2) if variant == "inputaware" else (x, y)
        timed(variant, lambda: step(stateC, stateG, cm, nf, batch, gen))
        del C_, G, cm, nf, stateC, stateG, step
    torch.manual_seed(4)
    C_, G = get_classifier(cfg).to(dev), freeze(get_generator(cfg, "grid").to(dev))
    stateC = TrainState(C_, sched)
    vstep = variants.make_wanet_victim_train_step(cfg, C_, G)
    timed("victim wanet", lambda: vstep(stateC, (x, y, poisoned), gen))
    return {f"{cfg.compute_dtype}/{key} memory": memory}


def _no_grad(fn, *args, **kw):
    import torch

    with torch.no_grad():
        return fn(*args, **kw)


def _to(obj, dev):
    """Draws (a tensor, None, a list of masks, or a NamedTuple of them) on ``dev``."""
    import torch

    if obj is None or isinstance(obj, torch.Tensor):
        return obj if obj is None else obj.to(dev)
    if isinstance(obj, list):
        return [_to(v, dev) for v in obj]
    return type(obj)(*(_to(v, dev) for v in obj))


# Phases 5f-5k: (phase, entry point, saving prefix, flags, launches of K1, K2
# and K3 predicted from the code).  256 images: 2 steps, then one eval batch
# of the 51 test rows.
_CLEAN = ["--load_checkpoint_clean", "smoke_clean"]
VARIANT_PHASES = (
    ("5f wanet", "train_generator_wanet", "smoke_wanet", _CLEAN, (0, 0, 0)),
    ("5g inputaware", "train_generator_inputaware", "smoke_ia", _CLEAN, (2 * 3 + 2, 2 * 2, 0)),
    ("5h inputaware K3", "train_generator_inputaware", "smoke_ia3",
     _CLEAN + ["--pallas_trigger", "false", "--pallas_lowfreq", "true"], (0, 0, 2 * 5 + 2)),
    ("5i imperceptible", "train_generator_imperceptible", "smoke_imp", _CLEAN, (2 * 2 + 1, 2, 0)),
    ("5j multilabel", "train_generator_multilabel", "smoke_ml", _CLEAN, (2 * 2 + 10, 2, 0)),
    ("5k victim wanet", "train_victim_wanet", "smoke_vwanet", ["--load_checkpoint", "smoke_wanet_clean"], (0, 0, 0)),
    ("5k victim inputaware", "train_victim_inputaware", "smoke_via", ["--load_checkpoint", "smoke_ia_clean"],
     (2 + 2, 0, 0)),
    ("5k victim imperceptible", "train_victim_imperceptible", "smoke_vimp", ["--load_checkpoint", "smoke_imp_clean"],
     (2 + 1, 0, 0)),
    ("5k victim multilabel", "train_victim_multilabel", "smoke_vml",
     ["--load_checkpoint", "smoke_ml_clean"] + _CLEAN, (2 * 2 + 10, 2, 0)),
)
KERNEL_NAMES = ("fused_trigger_fwd", "fused_trigger_bwd", "low_freq")
# The alternated stages: a generator, and the multilabel victim, which
# continues alternated training.  Each writes the --image_every grid (its
# default 20 takes epoch 0) where tensorboard is importable, one trigger call
# on the first 16 test rows by the flags' route: K1 on the fused route, K3 on
# the K3 route, no kernel on ATen's, none for the WaNet warp.
GRID_ENTRIES = ("train_generator", "train_generator_inputaware", "train_generator_imperceptible",
                "train_generator_multilabel", "train_victim_multilabel")


def _flag(flags, name: str, default: bool) -> bool:
    return flags[flags.index(name) + 1] == "true" if name in flags else default


def with_grid(entry: str, flags, predicted, grids: int = 1):
    """``predicted`` (K1, K2, K3) of an entry point's run with its ``grids``
    grids' launches added (:data:`GRID_ENTRIES`)."""
    from combat_tpu_torch.utils.logging import summary_writer_class

    if entry.rsplit(".", 1)[-1] not in GRID_ENTRIES or summary_writer_class() is None:
        return tuple(predicted)
    k1, k2, k3 = predicted
    if _flag(flags, "--pallas_trigger", True):
        k1 += grids
    elif _flag(flags, "--pallas_lowfreq", False):
        k3 += grids
    return k1, k2, k3


def run_variant_phases(common, workdir) -> dict:
    """Phases 5f-5k: each entry point with the launch counts set to 0 just
    before it, held to its predicted counts just after; its checkpoint
    finite, its best metrics percentages.  Returns each phase's counts."""
    import importlib

    from combat_tpu_torch.ops import trigger_kernels as tk

    counts = {}
    for phase, entry, prefix, flags, predicted in VARIANT_PHASES:
        t0 = time.perf_counter()
        main_fn = importlib.import_module(f"combat_tpu_torch.cli.{entry}").main
        tk.reset_launch_counts()
        best = main_fn(common + ["--synthetic_size", "256", "--saving_prefix", prefix] + flags)
        counts[phase] = dict(tk.LAUNCHES)
        check_checkpoint(f"{workdir}/{prefix}_clean/cifar10/cifar10_{prefix}_clean.pt")
        if not all(0.0 <= v <= 100.0 for v in best.values()):  # also false for NaN
            raise SystemExit(f"phase {phase}: best metrics are not percentages: {best}")
        predicted = with_grid(entry, flags, predicted)
        if counts[phase] != dict(zip(KERNEL_NAMES, predicted)):
            raise SystemExit(f"phase {phase} launched {counts[phase]}, predicted {dict(zip(KERNEL_NAMES, predicted))}")
        _phase(f"{phase} ({entry})", t0)
    return counts


# Phases 5l-5q: celeba and imagenet10 through the entry points, each with the
# launch counts set to 0 just before it and held just after it to the counts
# of K1, K2 and K3 predicted from the code.  An alternated step launches K1
# twice (the C-step's trigger and the G-step's) and K2 once, or K3 three
# times on its route (the C-step's forward, the G-step's forward and
# backward); a victim step and every eval batch launch K1 once.  celeba: 256
# images at bs 128 (2 steps), then one eval batch of its 51 test rows, on
# the committed celeba detector; imagenet10: 64 images at bs 32 (2 steps),
# then one eval batch of its 12 test rows, through the tiled kernels.
_CELEBA = ["--dataset", "celeba", "--bs", "128", "--synthetic_size", "256"]
_IMAGENET = ["--dataset", "imagenet10", "--bs", "32", "--synthetic_size", "64"]
_K3 = ["--pallas_trigger", "false", "--pallas_lowfreq", "true"]
LARGE_PHASES = (  # (phase, entry point, saving prefix or None, flags, (K1, K2, K3))
    ("5l celeba clean", "train_clean_classifier", "smoke_celeba", _CELEBA, (0, 0, 0)),
    ("5l celeba generator", "train_generator", "smoke_celeba_atk",
     _CELEBA + ["--load_checkpoint_clean", "smoke_celeba"], (2 * 2 + 1, 2, 0)),
    ("5m imagenet10 clean", "train_clean_classifier", "smoke_in", _IMAGENET, (0, 0, 0)),
    ("5n imagenet10 generator", "train_generator", "smoke_in_atk",
     _IMAGENET + ["--load_checkpoint_clean", "smoke_in"], (2 * 2 + 1, 2, 0)),
    ("5o imagenet10 generator K3", "train_generator", "smoke_in_k3",
     _IMAGENET + ["--load_checkpoint_clean", "smoke_in"] + _K3, (0, 0, 2 * 3 + 1)),
    ("5p imagenet10 victim", "train_victim", "smoke_in_vic",
     _IMAGENET + ["--load_checkpoint", "smoke_in_atk_clean"], (2 + 1, 0, 0)),
    ("5q imagenet10 eval", "eval", None,
     _IMAGENET + ["--load_checkpoint_clean", "smoke_in_vic_clean", "--load_checkpoint", "smoke_in_atk_clean"],
     (1, 0, 0)),
)


# Phases 5zh-5zi: the four variants at celeba (64 px, the one-plane kernels at
# their largest H) on 5l's clean classifier and at imagenet10 (224 px, the
# tiled kernels) on 5m's, each stage held to its counts as in 5f-5k: 2 steps,
# then one eval batch (celeba's 51 test rows at bs 128, imagenet10's 12 at bs
# 32).  An input-aware step triggers three times (K1 x3) and pulls two of them
# back (K2 x2), its eval batch twice; the multilabel eval triggers once a
# class, K = 8 at celeba and 10 at imagenet10; the multilabel victim continues
# alternated training.  imagenet10 has no detector in the repo, so its
# generators run a random one and record it.
def _variant_stages(phase, data, clean, k):
    """The four variant generators on the clean run ``clean``, then their
    victims, saved under ``clean``'s prefix: (phase, entry point, saving
    prefix, flags, (K1, K2, K3))."""
    prefix = clean
    clean_flags = data + ["--load_checkpoint_clean", clean]
    victim = lambda p: data + ["--load_checkpoint", f"{prefix}_{p}_clean"]  # noqa: E731
    return (
        (f"{phase} wanet", "train_generator_wanet", f"{prefix}_wanet", clean_flags, (0, 0, 0)),
        (f"{phase} inputaware", "train_generator_inputaware", f"{prefix}_ia", clean_flags, (2 * 3 + 2, 2 * 2, 0)),
        (f"{phase} imperceptible", "train_generator_imperceptible", f"{prefix}_imp", clean_flags, (2 * 2 + 1, 2, 0)),
        (f"{phase} multilabel", "train_generator_multilabel", f"{prefix}_ml", clean_flags, (2 * 2 + k, 2, 0)),
        (f"{phase} victim wanet", "train_victim_wanet", f"{prefix}_vwanet", victim("wanet"), (0, 0, 0)),
        (f"{phase} victim inputaware", "train_victim_inputaware", f"{prefix}_via", victim("ia"), (2 + 2, 0, 0)),
        (f"{phase} victim imperceptible", "train_victim_imperceptible", f"{prefix}_vimp", victim("imp"),
         (2 + 1, 0, 0)),
        (f"{phase} victim multilabel", "train_victim_multilabel", f"{prefix}_vml",
         victim("ml") + ["--load_checkpoint_clean", clean], (2 * 2 + k, 2, 0)),
    )


VARIANT_LARGE_PHASES = (
    *_variant_stages("5zh celeba", _CELEBA, "smoke_celeba", 8),
    *_variant_stages("5zi imagenet10", _IMAGENET, "smoke_in", 10),
)


# Phase 5zi's route parity: the input-aware and the multilabel train step at
# imagenet10 (224 px, bs 32, full width) on the K1/K2 route and on the ATen
# route, from the same weights and draws.  The two routes compute the same
# function and differ by float32 rounding, which phase 2 measures: at most
# eps, the larger of K1's and K2's errors against their plain versions
# (4.77e-7 on an NVIDIA H100 80GB HBM3).  The yardstick is the ATen step run again
# on its images plus Gaussian noise of that eps: how far an eps-sized
# difference moves the step's losses and G's updated parameters through a
# ResNet18 forward and backward and the UNet's atomics.  The routes may
# differ by at most ROUTE_GAIN times that, or than the float32 spacing of the
# values compared (eps_32 * |value|: a loss of ~2.4 is resolved to 2.4e-7
# only, and on an H100 the noise moved the multilabel step's losses by less
# than that, 0, while the routes sat 2 spacings apart); a trigger that is
# wrong anywhere moves the losses by ~1e-2 and G by its whole update.
ROUTE_GAIN = 10.0
ROUTE_PARITY = (  # (variant, generator kind, losses, K1/K2/K3 launches of one step on the K1/K2 route)
    ("inputaware", "unet", ("loss_ce", "loss_cross", "loss_l2", "clean_model_loss"), (3, 2, 0)),
    ("multilabel", "cunet", ("loss_ce", "loss_l2", "clean_model_loss"), (2, 1, 0)),
)


def route_parity(eps: float) -> dict:
    """Phase 5zi: each of ``ROUTE_PARITY``'s steps on the K1/K2 route, on
    the ATen route, and on the ATen route with its images plus noise of
    ``eps``, from the same weights and draws; the route gaps held to
    ``ROUTE_GAIN`` times the noise's or one float32 spacing's, whichever is
    larger (see above), each step's launches as predicted.  These launches
    compare a route with the plain one and are not counted on the main
    path.  Returns each step's gaps."""
    import torch

    from combat_tpu_torch.cli.common import setup_device
    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.ops import trigger_kernels as tk
    from combat_tpu_torch.train import TrainState, draw_alternated, draw_inputaware, freeze, multistep_lr
    from combat_tpu_torch.train import variants

    data = apply_dataset_preset(Config(dataset="imagenet10"))
    dev = setup_device(data)
    n, h = data.bs, data.input_height
    sched = multistep_lr(0.01, (100,), 0.1, 10)
    out = {}
    for variant, kind, losses, predicted in ROUTE_PARITY:
        torch.manual_seed(9)
        weights = [get_classifier(data), get_generator(data, kind), get_classifier(data), get_frequency_detector(data)]
        gen = torch.Generator(device=dev).manual_seed(10)
        images = [torch.rand((n, C, h, h), generator=gen, device=dev) * 2 - 1 for _ in range(2)]
        y = torch.arange(n, device=dev) % data.num_classes  # target-class rows, so the C-step poisons some
        draws = (draw_inputaware if variant == "inputaware" else draw_alternated)(data, n, gen, dev)
        noisy = [x + torch.randn(x.shape, generator=gen, device=dev) * eps for x in images]
        runs = {}
        for arm, fused, (x, x2) in (("K1/K2", True, images), ("ATen", False, images),
                                    ("ATen + noise", False, noisy)):
            cfg = data.replace(pallas_trigger=fused, pallas_lowfreq=False)
            C_, G, cm, nf = (copy.deepcopy(m).to(dev) for m in weights)
            stateC, stateG = TrainState(C_, sched), TrainState(G, sched)
            step = getattr(variants, f"make_{variant}_train_step")(cfg, C_, G)
            batch = (x, y, x2) if variant == "inputaware" else (x, y)
            tk.reset_launch_counts()
            m = step(stateC, stateG, freeze(cm), freeze(nf), batch, draws=draws)
            torch.cuda.synchronize()
            expected = dict(zip(KERNEL_NAMES, predicted if fused else (0, 0, 0)))
            if dict(tk.LAUNCHES) != expected:
                raise SystemExit(f"5zi {variant} step on the {arm} route launched {dict(tk.LAUNCHES)}, "
                                 f"predicted {expected}")
            runs[arm] = ({k: float(m[k]) for k in losses}, {k: v.detach().cpu() for k, v in G.state_dict().items()})
            del C_, G, cm, nf, stateC, stateG, step, m
        (m_k, g_k), (m_a, g_a), (m_n, g_n) = (runs[arm] for arm in ("K1/K2", "ATen", "ATen + noise"))
        spacing = torch.finfo(torch.float32).eps
        floats = [k for k, v in g_a.items() if v.is_floating_point()]
        loss_gap = max(abs(m_k[k] - m_a[k]) for k in losses)
        loss_yard = max(max(abs(m_n[k] - m_a[k]) for k in losses), spacing * max(abs(m_a[k]) for k in losses))
        g_gap = max(float((g_k[k] - g_a[k]).abs().max()) for k in floats)
        g_yard = max(max(float((g_n[k] - g_a[k]).abs().max()) for k in floats),
                     spacing * max(float(g_a[k].abs().max()) for k in floats))
        out[variant] = {"loss_gap": loss_gap, "loss_noise_gap": loss_yard, "G_gap": g_gap, "G_noise_gap": g_yard,
                        "eps": eps}
        print(f"  5zi route parity, {variant} step at 224 px (bs {n}): K1/K2 vs ATen: losses {loss_gap:.3e}, "
              f"G {g_gap:.3e}; ATen with its images + N(0, {eps:.2e}), or one float32 spacing where larger: "
              f"losses {loss_yard:.3e}, G {g_yard:.3e} (the route gaps may be {ROUTE_GAIN:g} x these); loss_ce "
              f"{m_k['loss_ce']:.6f} vs {m_a['loss_ce']:.6f}", flush=True)
        if not (loss_gap <= ROUTE_GAIN * loss_yard and g_gap <= ROUTE_GAIN * g_yard):
            raise SystemExit(f"5zi: the {variant} step's K1/K2 and ATen routes disagree at 224 px: {out[variant]}")
    return out


@contextlib.contextmanager
def _save_gates_open():
    """Every epoch of the entry points saves its checkpoint while this is
    open.  The reference's gates save only an accuracy above the best so
    far, which starts at 0; after 2 steps at 224 px the classifier's
    BatchNorm statistics are still near their initial values, and its eval
    accuracy on 12 test rows can be 0 (a first run scored 0 on 32 rows), so
    nothing would be saved for the next stage to load."""
    from combat_tpu_torch.cli import _alternated, _victim, train_clean_classifier

    names = ((train_clean_classifier, "best_gate_clean"), (_victim, "best_gate_clean"),
             (_alternated, "best_gate_attack"))
    gates = [(m, name, getattr(m, name)) for m, name in names]
    for m, name, _ in gates:
        setattr(m, name, lambda *a: True)
    try:
        yield
    finally:
        for m, name, gate in gates:
            setattr(m, name, gate)


# Phases 5r-5t: --compute_dtype bfloat16 through the entry points.  The
# trigger runs in float32 in either dtype (the JAX recipe's
# noise.astype(x.dtype)), so each phase launches K1, K2 and K3 as its float32
# counterpart does, predicted from the code in the same way: 5r the cifar10
# main path (the counterparts of 3, 4, 5, 5c and 5e at 256 images: 2 steps,
# then one eval batch of 51 rows), 5s the input-aware and multilabel generators
# (5g, 5j), 5t the imagenet10 generator at 224 px through the tiled K1/K2
# (5n) on 5m's float32 clean model, then a float32 victim of that bfloat16
# generator (5p): checkpoints cross between the dtypes.  Every checkpoint
# holds float32 parameters and statistics.
_BF16 = ["--compute_dtype", "bfloat16"]
_CIFAR_BF16 = ["--dataset", "cifar10", "--bs", "128", "--synthetic_size", "256"] + _BF16
BF16_PHASES = (  # (phase, entry point, saving prefix or None, flags, (K1, K2, K3))
    ("5r bf16 clean", "train_clean_classifier", "smoke_bf", _CIFAR_BF16, (0, 0, 0)),
    ("5r bf16 generator", "train_generator", "smoke_bf_atk", _CIFAR_BF16 + ["--load_checkpoint_clean", "smoke_bf"],
     (2 * 2 + 1, 2, 0)),
    ("5r bf16 generator K3", "train_generator", "smoke_bf_k3",
     _CIFAR_BF16 + ["--load_checkpoint_clean", "smoke_bf"] + _K3, (0, 0, 2 * 3 + 1)),
    ("5r bf16 victim", "train_victim", "smoke_bf_vic", _CIFAR_BF16 + ["--load_checkpoint", "smoke_bf_atk_clean"],
     (2 + 1, 0, 0)),
    ("5r bf16 eval", "eval", None,
     _CIFAR_BF16 + ["--load_checkpoint_clean", "smoke_bf_vic_clean", "--load_checkpoint", "smoke_bf_atk_clean"],
     (1, 0, 0)),
    ("5s bf16 inputaware", "train_generator_inputaware", "smoke_bf_ia",
     _CIFAR_BF16 + ["--load_checkpoint_clean", "smoke_bf"], (2 * 3 + 2, 2 * 2, 0)),
    ("5s bf16 multilabel", "train_generator_multilabel", "smoke_bf_ml",
     _CIFAR_BF16 + ["--load_checkpoint_clean", "smoke_bf"], (2 * 2 + 10, 2, 0)),
    ("5t bf16 imagenet10 generator", "train_generator", "smoke_bf_in_atk",
     _IMAGENET + _BF16 + ["--load_checkpoint_clean", "smoke_in"], (2 * 2 + 1, 2, 0)),
    ("5t float32 imagenet10 victim of the bf16 generator", "train_victim", "smoke_bf_in_vic",
     _IMAGENET + ["--load_checkpoint", "smoke_bf_in_atk_clean"], (2 + 1, 0, 0)),
)


# Phases 5u-5w: the rest of the model registry through the entry points.  A
# new --model or --F_model does not touch the trigger route, so each stage
# launches what its cifar10 counterpart in phases 3-5e launches at 256 images
# (2 steps, then one eval batch of 51 rows): a clean classifier nothing, a
# generator K1 2 x 2 + 1 and K2 2, a victim K1 2 + 1, the final eval K1
# once.  The detectors of 5v have no .pt in the repo: each runs random, as
# the JAX package would, and its checkpoint records F_detector_loaded false.
_CIFAR = ["--dataset", "cifar10", "--bs", "128", "--synthetic_size", "256"]
_GTSRB = ["--dataset", "gtsrb", "--bs", "128", "--synthetic_size", "256"]
_GENERATOR, _VICTIM = (2 * 2 + 1, 2, 0), (2 + 1, 0, 0)


def _four_stages(phase, name, data, flags=()):
    """clean -> generator -> victim -> eval with ``flags`` on every stage."""
    flags, p = list(data) + list(flags), f"smoke_{name}"
    return (
        (f"{phase} {name} clean", "train_clean_classifier", p, flags, (0, 0, 0)),
        (f"{phase} {name} generator", "train_generator", f"{p}_atk", flags + ["--load_checkpoint_clean", p],
         _GENERATOR),
        (f"{phase} {name} victim", "train_victim", f"{p}_vic", flags + ["--load_checkpoint", f"{p}_atk_clean"],
         _VICTIM),
        (f"{phase} {name} eval", "eval", None,
         flags + ["--load_checkpoint_clean", f"{p}_vic_clean", "--load_checkpoint", f"{p}_atk_clean"], (1, 0, 0)),
    )


def _generator_only(name, phase="5u", data=_CIFAR, prefix=None):
    flags, p = list(data) + ["--model", name], prefix or f"smoke_{name}"
    return (
        (f"{phase} {name} clean", "train_clean_classifier", p, flags, (0, 0, 0)),
        (f"{phase} {name} generator", "train_generator", f"{p}_atk", flags + ["--load_checkpoint_clean", p],
         _GENERATOR),
    )


def _detector_phases(F_model):
    flags, p = _CIFAR + ["--F_model", F_model], f"smoke_F_{F_model}"
    return (
        (f"5v {F_model} generator", "train_generator", p, flags + _CLEAN, _GENERATOR),
        (f"5v {F_model} eval", "eval", None,
         flags + ["--load_checkpoint_clean", "smoke_vic_clean", "--load_checkpoint", f"{p}_clean"], (1, 0, 0)),
    )


ZOO_PHASES = (  # (phase, entry point, saving prefix or None, flags, (K1, K2, K3))
    *(stage for name in ("vgg16", "densenet121", "simplevitsmall8")
      for stage in _four_stages("5u", name, _CIFAR, ["--model", name])),
    *(stage for name in ("preactresnet10", "preactresnet34", "vgg11", "vgg13", "vgg19", "mobilenetv2", "vit",
                         "vitsmall") for stage in _generator_only(name)),
    *(stage for F_model in ("original_dropout", "original_dropout_ensemble", "densenet121")
      for stage in _detector_phases(F_model)),
    *_four_stages("5w", "gtsrb", _GTSRB),
)


def ensemble_stays_live() -> None:
    """Phase 5v: the dropout-ensemble detector, frozen on the card, gives
    other logits on each call with the same input (its dropout is live in
    eval mode), and the same logits with the same masks."""
    import torch

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_frequency_detector
    from combat_tpu_torch.train import freeze

    dev = torch.device("cuda", 0)
    netF = freeze(get_frequency_detector(apply_dataset_preset(Config(F_model="original_dropout_ensemble"))).to(dev))
    x = torch.rand((8, C, H, H), generator=torch.Generator(device=dev).manual_seed(9), device=dev) * 200 - 100
    masks = netF.draw_masks(8, torch.Generator(device=dev).manual_seed(10), dev)
    with torch.no_grad():
        a, b, m1, m2 = netF(x), netF(x), netF(x, masks), netF(x, masks)
    if torch.equal(a, b) or not torch.equal(m1, m2):
        raise SystemExit("the frozen dropout-ensemble detector's dropout is not live on the card")
    print(f"  5v ensemble after freeze: two calls differ by {float((a - b).abs().max()):.3e}; "
          "the same masks give the same logits", flush=True)


# Phases 5x-5z: the defenses (combat_tpu_torch/defenses/) through their entry
# points, on the checkpoints of phases 3-5 (cifar10: smoke_clean, smoke_atk,
# smoke_vic) and 5m-5q (imagenet10: smoke_in, smoke_in_atk, smoke_in_vic),
# run from the work folder (they write ./results there, as the JAX package
# does), each with the launch counts set to 0 just before it and held after
# it to the counts of K1, K2 and K3 predicted from the code.  No defense
# differentiates through the trigger, so K2 is 0 in every phase, and each
# trigger call is one K1 launch (the tiled K1 at 224 px): none in
# frequency_train, Neural Cleanse, combine_images and STRIP's clean mode;
# one a round in STRIP's attack mode (its backgrounds), one a test batch in
# frequency_eval, one on Grad-CAM's 16 images; in fine-pruning one a batch
# of 256, not one a mask (the full synthetic test split of 10,000 rows is 39
# whole batches); a generator run 2 x 2 + 1 and K2 2 (phase 5u's count).
_F = ["--F_checkpoints", "F"]  # the detectors go under the work folder, not over the committed ones
_VIC = ["--dataset", "cifar10", "--synthetic_size", "1024", "--saving_prefix", "smoke_vic"]
_IN_VIC = _IMAGENET + ["--saving_prefix", "smoke_in_vic"]
DETECTOR_KEYS = {"netC", "optimizerC", "best_acc", "epoch_current"}


def _check_detector(dataset, F_model):
    """frequency_train saved the JAX package's keys where the generator
    stages load the detector from."""
    def check(best_acc):
        payload = check_checkpoint(f"F/{dataset}/{F_model}/{dataset}_{F_model}_detector.pt")
        if set(payload) != DETECTOR_KEYS or payload["best_acc"] != best_acc:
            raise SystemExit(f"{F_model} detector checkpoint: keys {sorted(payload)}, best_acc {payload['best_acc']}")
        return best_acc
    return check


def _check_loaded(prefix):
    def check(best):
        payload = check_checkpoint(f"{prefix}_clean/cifar10/cifar10_{prefix}_clean.pt")
        if payload["F_detector_loaded"] is not True:
            raise SystemExit("the generator did not load the detector the port trained")
        return {"F_detector_loaded": True, **best}
    return check


def _check_percentages(result):
    if not all(0.0 <= v <= 100.0 for v in result):  # also false for NaN
        raise SystemExit(f"frequency_eval's rates are not percentages: {result}")
    return result


def _check_strip(folder, trojan, benign, dataset="cifar10"):
    def check(result):
        import numpy as np

        with open(f"{folder}/{dataset}/{dataset}_result.txt") as f:
            lines = f.read().split("\n")
        tro, ben = ([float(np.float32(v)) for v in ln.split()] for ln in lines)  # the entries are float32
        if len(lines) != 2 or (len(tro), len(ben)) != (trojan, benign) or not all(
                0 <= e < float("inf") for e in tro + ben):
            raise SystemExit(f"STRIP's result file: {len(tro)} trojan, {len(ben)} benign entropies")
        if result != (min(tro + ben), min(tro + ben) < 0.2):
            raise SystemExit(f"STRIP's verdict {result} is not its file's")
        return result
    return check


def _check_nc(result):
    import numpy as np

    res = "results/smoke_vic_clean/cifar10"
    for lab in range(10):
        mask, pattern = np.load(f"{res}/mask_{lab}.npy"), np.load(f"{res}/pattern_{lab}.npy")
        if mask.shape != (H, H) or pattern.shape != (H, H, C) or not (0 <= mask.min() and mask.max() <= 1):
            raise SystemExit(f"Neural Cleanse label {lab}: mask {mask.shape}, pattern {pattern.shape}")
    if not os.path.getsize(f"{res}/cifar10_smoke_vic_output.txt"):
        raise SystemExit("Neural Cleanse wrote no verdict")
    return {k: result[k] for k in ("anomaly_index", "backdoored")}


def _check_png(path):
    with open(path, "rb") as f:
        if f.read(8) != b"\x89PNG\r\n\x1a\n":
            raise SystemExit(f"{path} is not a PNG")
    return path


def _check_fine_pruning(path):
    import re

    def check(results):
        with open(path) as f:
            lines = f.read().splitlines()
        if len(lines) != 513 or not all(re.fullmatch(rf"{i} \d+\.\d{{4}} \d+\.\d{{4}}", ln)
                                        for i, ln in enumerate(lines)):
            raise SystemExit(f"{path}: {len(lines)} lines, not 513 in the JAX format")
        return {"clean, bd at 0 / 256 / 512 pruned": [lines[0], lines[256], lines[512]]}
    return check


def _check_gradcam(out_dir):
    import numpy as np

    for prefix in ("victim_", "victim_clean_", "cleanmodel_"):
        for kind in ("bd", "cam", "heatmap"):
            for i in range(16):
                _check_png(f"{out_dir}/{prefix}{kind}{i}.png")
    gb = np.load(f"{out_dir}/guided_backprop.npy")
    if gb.shape != (4, H, H, C) or not np.isfinite(gb).all():
        raise SystemExit(f"guided_backprop.npy: {gb.shape}")
    return out_dir


DEFENSE_PHASES = (  # (phase, module, flags, (K1, K2, K3), check of its result and files)
    ("5x frequency_train original_dropout", "defenses.frequency_train",
     _CIFAR + ["--F_model", "original_dropout", "--n_iters", "2"] + _F, (0, 0, 0),
     _check_detector("cifar10", "original_dropout")),
    ("5x generator on the trained detector", "cli.train_generator",
     _CIFAR + ["--F_model", "original_dropout", "--saving_prefix", "smoke_F_trained"] + _F + _CLEAN, _GENERATOR,
     _check_loaded("smoke_F_trained")),
    ("5x frequency_eval", "defenses.frequency_eval",
     _CIFAR + ["--F_model", "original_dropout", "--load_checkpoint", "smoke_F_trained_clean"] + _F, (1, 0, 0),
     _check_percentages),
    ("5x frequency_train preactresnet18", "defenses.frequency_train", _CIFAR + ["--F_model", "preactresnet18"] + _F,
     (0, 0, 0), _check_detector("cifar10", "preactresnet18")),
    ("5y STRIP attack", "defenses.strip", _VIC + ["--test_rounds", "2", "--results", "strip_attack"], (2, 0, 0),
     _check_strip("strip_attack", 200, 200)),
    ("5y STRIP clean", "defenses.strip", _VIC + ["--test_rounds", "2", "--strip_mode", "clean", "--results",
                                                 "strip_clean"], (0, 0, 0), _check_strip("strip_clean", 0, 200)),
    ("5y Neural Cleanse", "defenses.neural_cleanse", _VIC + ["--nc_epochs", "2"], (0, 0, 0), _check_nc),
    ("5y combine_images", "defenses.combine_images", ["--saving_prefix", "smoke_vic"], (0, 0, 0), _check_png),
    ("5y fine-pruning", "defenses.fine_pruning", ["--dataset", "cifar10", "--saving_prefix", "smoke_vic"],
     (39, 0, 0), _check_fine_pruning("fine_pruning_results.txt")),
    ("5y Grad-CAM", "defenses.gradcam", _VIC + ["--load_checkpoint_clean", "smoke_clean"], (1, 0, 0),
     _check_gradcam),
    ("5z STRIP attack 224 px", "defenses.strip", _IN_VIC + ["--test_rounds", "1", "--results", "strip_in"],
     (1, 0, 0), _check_strip("strip_in", 12, 12, "imagenet10")),
    ("5z fine-pruning 224 px", "defenses.fine_pruning", _IN_VIC + ["--outfile", "fp_in.txt"], (1, 0, 0),
     _check_fine_pruning("fp_in.txt")),
    ("5z frequency_train original 224 px", "defenses.frequency_train", _IMAGENET + ["--F_model", "original"] + _F,
     (0, 0, 0), _check_detector("imagenet10", "original")),
    ("5z frequency_eval 224 px", "defenses.frequency_eval",
     _IMAGENET + ["--F_model", "original", "--load_checkpoint", "smoke_in_atk_clean"] + _F, (1, 0, 0),
     _check_percentages),
)


# Phases 5za-5zc: the extended zoo (models/zoo_extra.py) through the entry
# points, each phase held to counts predicted as for 5u-5w (a --model or
# --F_model leaves the trigger route alone: a clean classifier nothing, a
# generator K1 2 x 2 + 1 and K2 2, a victim K1 2 + 1, an eval or
# frequency_eval K1 once, frequency_train nothing).  5za: cifar10, bs 128,
# 256 images, GoogLeNet, DPN92 and SENet18 through the four stages and the
# other trainable names through a clean classifier and a generator, then
# --model efficientnetb0, whose C-step stops (:func:`efficientnet_stops`);
# 5zb: frequency_train --F_model efficientnetb0 (2 epochs, its dropout masks
# drawn on the card), a generator that must load that detector and its
# frequency_eval, from the work folder as 5x, and --F_model shufflenetv2 in a
# generator, a random detector recorded as such; 5zc: celeba (64 px)
# ShuffleNetG2 and imagenet10 (224 px, bs 32, 64 images, the tiled K1/K2)
# MobileNetV1, each a clean classifier and a generator.
ZOO_EXTRA_FOUR_STAGES = ("googlenet", "dpn92", "senet18")
ZOO_EXTRA_GENERATORS = ("lenet", "mobilenet", "dpn26", "shufflenetg2", "shufflenetv2", "resnext29_2x64d",
                        "resnext29_32x4d", "pnasneta", "pnasnetb")
ZOO_EXTRA_PHASES = (  # (phase, entry point, saving prefix or None, flags, (K1, K2, K3))
    *(stage for name in ZOO_EXTRA_FOUR_STAGES for stage in _four_stages("5za", name, _CIFAR, ["--model", name])),
    *(stage for name in ZOO_EXTRA_GENERATORS for stage in _generator_only(name, "5za")),
    ("5zb shufflenetv2 detector generator", "train_generator", "smoke_F_shufflenetv2",
     _CIFAR + ["--F_model", "shufflenetv2"] + _CLEAN, _GENERATOR),
    *_generator_only("shufflenetg2", "5zc celeba", _CELEBA, "smoke_celeba_sg2"),
)
ZOO_EXTRA_224_PHASES = _generator_only("mobilenet", "5zc imagenet10", _IMAGENET, "smoke_in_mb")
ZOO_EXTRA_DETECTOR_PHASES = (  # (phase, module, flags, (K1, K2, K3), check of its result and files)
    ("5zb frequency_train efficientnetb0", "defenses.frequency_train",
     _CIFAR + ["--F_model", "efficientnetb0", "--n_iters", "2"] + _F, (0, 0, 0),
     _check_detector("cifar10", "efficientnetb0")),
    ("5zb generator on the efficientnetb0 detector", "cli.train_generator",
     _CIFAR + ["--F_model", "efficientnetb0", "--saving_prefix", "smoke_F_effnet"] + _F + _CLEAN, _GENERATOR,
     _check_loaded("smoke_F_effnet")),
    ("5zb frequency_eval efficientnetb0", "defenses.frequency_eval",
     _CIFAR + ["--F_model", "efficientnetb0", "--load_checkpoint", "smoke_F_effnet_clean"] + _F, (1, 0, 0),
     _check_percentages),
)


def efficientnet_stops(workdir) -> str:
    """Phase 5za: ``--model efficientnetb0`` stops at its C-step with a
    ``NotImplementedError`` that names the dropout rng the JAX C-steps do
    not pass (they stop there with ``InvalidRngError``).  Any other outcome
    fails the run."""
    from combat_tpu_torch.cli import train_clean_classifier

    argv = ["--device", "cuda", "--synthetic_data", "--n_iters", "1", "--checkpoints", workdir, *_CIFAR,
            "--model", "efficientnetb0", "--saving_prefix", "smoke_effnet"]
    try:
        train_clean_classifier.main(argv)
    except NotImplementedError as e:
        if "'dropout' rng" not in str(e):
            raise SystemExit(f"--model efficientnetb0 stopped, but not for its dropout rng: {e}") from e
        print(f"  5za efficientnetb0 as --model: stops as the JAX package does, NotImplementedError: {e}", flush=True)
        return str(e)
    raise SystemExit("--model efficientnetb0 trained a C-step, which the JAX package cannot")


def run_defense_phases(workdir, phases=DEFENSE_PHASES) -> dict:
    """Phases 5x-5z (``DEFENSE_PHASES``) or 5zb's detector
    (``ZOO_EXTRA_DETECTOR_PHASES``), from the work folder, with the attack's
    save gates open: each entry point with the launch counts set to 0 just
    before it, held to its predicted counts just after, its result and its
    files checked.  Returns each phase's counts."""
    import importlib

    from combat_tpu_torch.ops import trigger_kernels as tk

    base = ["--device", "cuda", "--synthetic_data", "--n_iters", "1", "--checkpoints", workdir]
    counts = {}
    with _save_gates_open(), contextlib.chdir(workdir):
        for phase, module, flags, predicted, check in phases:
            t0 = time.perf_counter()
            main_fn = importlib.import_module(f"combat_tpu_torch.{module}").main
            tk.reset_launch_counts()
            result = main_fn(flags if module.endswith("combine_images") else base + flags)  # its own parser
            counts[phase] = dict(tk.LAUNCHES)
            shown = check(result)
            expected = dict(zip(KERNEL_NAMES, with_grid(module, flags, predicted)))
            if counts[phase] != expected:
                raise SystemExit(f"phase {phase} launched {counts[phase]}, predicted {expected}")
            print(f"  {phase}: {shown}", flush=True)
            _phase(f"{phase} ({module})", t0)
    return counts


def _float32_state(payload: dict, path: str) -> None:
    """The models a checkpoint holds keep float32 parameters and statistics
    in either compute dtype."""
    import torch

    for key, sd in payload.items():
        if key.startswith("net") or key == "clean_model":
            bad = {k: t.dtype for k, t in sd.items() if t.is_floating_point() and t.dtype != torch.float32}
            if bad:
                raise SystemExit(f"{path}: {key} holds tensors that are not float32: {bad}")


def run_phases(workdir, phases) -> dict:
    """Phases 5l-5q (``LARGE_PHASES``), 5r-5t (``BF16_PHASES``) or 5u-5w
    (``ZOO_PHASES``): each entry point with the launch counts set to 0 just
    before it, held to its predicted counts just after; its checkpoint
    finite, with float32 models, its metrics percentages; a generator on
    the committed detector of its dataset where the repo holds one, and
    recorded as running without one elsewhere.  The save gates are open
    (:func:`_save_gates_open`).  Returns each phase's counts."""
    with _save_gates_open():
        return _run_phases(workdir, phases)


def _run_phases(workdir, phases) -> dict:
    import importlib

    from combat_tpu_torch.ops import trigger_kernels as tk

    base = ["--device", "cuda", "--synthetic_data", "--n_iters", "1", "--checkpoints", workdir]
    counts = {}
    for phase, entry, prefix, flags, predicted in phases:
        t0 = time.perf_counter()
        main_fn = importlib.import_module(f"combat_tpu_torch.cli.{entry}").main
        tk.reset_launch_counts()
        result = main_fn(base + flags + (["--saving_prefix", prefix] if prefix else []))
        counts[phase] = dict(tk.LAUNCHES)
        values = list(result.values()) if isinstance(result, dict) else list(result or ())  # eval: a tuple
        if not all(0.0 <= v <= 100.0 for v in values):  # also false for NaN
            raise SystemExit(f"phase {phase}: metrics are not percentages: {result}")
        if prefix:
            dataset = flags[flags.index("--dataset") + 1]
            name = prefix if entry == "train_clean_classifier" else f"{prefix}_clean"
            path = f"{workdir}/{name}/{dataset}/{dataset}_{name}.pt"
            payload = check_checkpoint(path)
            _float32_state(payload, path)
            F_model = flags[flags.index("--F_model") + 1] if "--F_model" in flags else "original"
            committed = dataset in ("cifar10", "celeba") and F_model == "original"  # the detectors in the repo
            alternated = entry.startswith("train_generator") or entry == "train_victim_multilabel"
            if alternated and payload["F_detector_loaded"] is not committed:
                raise SystemExit(f"phase {phase}: F_detector_loaded is {payload['F_detector_loaded']}, "
                                 f"expected {committed} for {dataset} and --F_model {F_model}")
        predicted = with_grid(entry, flags, predicted)
        if counts[phase] != dict(zip(KERNEL_NAMES, predicted)):
            raise SystemExit(f"phase {phase} launched {counts[phase]}, predicted {dict(zip(KERNEL_NAMES, predicted))}")
        print(f"  {phase}: {values}", flush=True)
        _phase(f"{phase} ({entry})", t0)
    return counts


# Phase 5zd: the cifar10 generator stage at the smoke phases' size (256
# images at bs 128: 2 steps, then one eval batch of 51 rows) for two epochs,
# a grid each epoch and a torch.profiler trace of the second: K1 2 x 2 + 1
# and K2 2 an epoch, and a K1 a grid where tensorboard is importable.
PROFILED = ["--synthetic_size", "256", "--saving_prefix", "smoke_profiled", "--load_checkpoint_clean", "smoke_clean",
            "--n_iters", "2", "--image_every", "1"]
DEVICE_KERNELS = ("fused_trigger_fwd_kernel", "fused_trigger_bwd_kernel")  # K1's and K2's at 32 px (trigger.cu)


def profiled_generator(common, workdir) -> dict:
    """Phase 5zd: the run's launches as predicted; one Chrome trace under
    its ``--profile_dir``, whose CUDA kernels include K1's and K2's, and
    whose ten costliest device operations are printed (a first view of the
    step, not a metric); the grids and scalars in the tensorboard event file
    where tensorboard is importable, else the JSONL record alone."""
    import glob

    from combat_tpu_torch.cli import train_generator
    from combat_tpu_torch.ops import trigger_kernels as tk
    from combat_tpu_torch.utils.logging import summary_writer_class

    t0 = time.perf_counter()
    trace_dir = f"{workdir}/trace"
    flags = PROFILED + ["--profile_dir", trace_dir]
    predicted = dict(zip(KERNEL_NAMES, with_grid("train_generator", flags, (2 * (2 * 2 + 1), 2 * 2, 0), grids=2)))
    tk.reset_launch_counts()
    best = train_generator.main(common + flags)
    counts = dict(tk.LAUNCHES)
    if counts != predicted:
        raise SystemExit(f"phase 5zd launched {counts}, predicted {predicted}")
    if not all(0.0 <= v <= 100.0 for v in best.values()):  # also false for NaN
        raise SystemExit(f"phase 5zd: best metrics are not percentages: {best}")
    traces = glob.glob(f"{trace_dir}/*.pt.trace.json")
    if len(traces) != 1:
        raise SystemExit(f"phase 5zd: {len(traces)} traces under {trace_dir}, expected one")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    missing = [k for k in DEVICE_KERNELS if not any(k in e["name"] for e in kernels)]
    if missing:
        raise SystemExit(f"phase 5zd: the trace's {len(kernels)} CUDA kernels do not include {missing}")
    per_name: dict = {}
    for e in kernels:
        per_name[e["name"]] = per_name.get(e["name"], 0.0) + float(e.get("dur", 0.0))
    busy_us = sum(per_name.values())
    span_us = max(e["ts"] + e.get("dur", 0) for e in kernels) - min(e["ts"] for e in kernels)
    print(f"  5zd traced epoch: {len(kernels)} kernel launches, {busy_us / 1e3:.3f} ms of kernels within "
          f"{span_us / 1e3:.3f} ms from the first to the last; the ten costliest:", flush=True)
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {us / 1e3:10.3f} ms  {name[:150]}", flush=True)
    log_dir = f"{workdir}/smoke_profiled_clean/cifar10/log_dir"
    with open(f"{log_dir}/train.jsonl") as f:
        groups = [(r["epoch"], r["group"]) for r in map(json.loads, f)]
    if groups != [(0, "meta"), (0, "train"), (0, "test"), (1, "train"), (1, "test")]:
        raise SystemExit(f"phase 5zd: JSONL records {groups}")
    if summary_writer_class() is None:
        print("  5zd: tensorboard is absent: no grid and no event file (the JAX package's behaviour); "
              "the JSONL record holds the scalars", flush=True)
    else:
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

        acc = EventAccumulator(log_dir)
        acc.Reload()
        images = [(e.step, e.width, e.height) for e in acc.Images("Images")]
        if images != [(0, 16 * H, 2 * H), (1, 16 * H, 2 * H)]:
            raise SystemExit(f"phase 5zd: grids {images}, expected 16 test rows above their triggered copies "
                             "at epochs 0 and 1")
        for tag in ("test/Clean", "test/Bd", "train/clean_correct"):
            if [e.step for e in acc.Scalars(tag)] != [0, 1]:
                raise SystemExit(f"phase 5zd: scalar {tag} at steps {[e.step for e in acc.Scalars(tag)]}")
        print(f"  5zd: tensorboard event file: grids {images}, {len(acc.Tags()['scalars'])} scalar tags", flush=True)
    _phase("5zd train_generator (--profile_dir, --image_every 1)", t0)
    return counts


# Phase 5ze: the reference's checkpoint layout into the port, through the
# importer on the card's torch.  The reference's names of the port's keys
# (the table combat_tpu_torch/checkpoint/torch_import.py documents): the
# detector's conv<i>/bn<i> are conv<i+1>/bn<i+1> and its head linear is
# linear6; the UNet's enc.<name>/dec.<name> are <name>; the PreActResNet's
# names are the reference's.  Two evals of 1024 synthetic rows (204 test
# rows: two batches at bs 128) launch K1 twice each.
IMPORTED = (2 * 2, 0, 0)


def _reference_names(kind: str, sd: dict) -> dict:
    import re

    if kind == "frequency":
        def rename(k):
            m = re.fullmatch(r"(conv|bn)(\d)\.(.+)", k)
            return f"{m[1]}{int(m[2]) + 1}.{m[3]}" if m else k.replace("linear.", "linear6.", 1)
    elif kind == "unet":
        def rename(k):
            return k.split(".", 1)[1]
    else:
        def rename(k):
            return k
    return {rename(k): v for k, v in sd.items()}


def imported_checkpoints(common, workdir) -> dict:
    """Phase 5ze: the committed cifar10 detector and phase 4's attack
    checkpoint written as the reference's ``.pth.tar`` files, imported with
    ``python -m combat_tpu_torch.checkpoint.torch_import`` (``weights_only``)
    and held to the originals bit for bit; ``cli/eval`` gives the same
    metrics on the imported attack as on the original, through K1 on the
    card."""
    import torch

    from combat_tpu_torch.cli import eval as final_eval
    from combat_tpu_torch.ops import trigger_kernels as tk

    t0 = time.perf_counter()
    detector = torch.load("defenses/frequency_based/checkpoints/cifar10/original/cifar10_original_detector.pt",
                          map_location="cpu", weights_only=True)
    atk = torch.load(f"{workdir}/smoke_atk_clean/cifar10/cifar10_smoke_atk_clean.pt", map_location="cpu",
                     weights_only=True)
    ref_dir = f"{workdir}/reference"
    os.makedirs(ref_dir)
    torch.save({"netC": _reference_names("frequency", detector["netC"]), "best_acc": 90.0, "epoch_current": 3},
               f"{ref_dir}/cifar10_original_detector.pth.tar")
    scalars = {k: v for k, v in atk.items() if k.startswith("best_") or k == "epoch_current"}
    torch.save({"netC": atk["netC"], "netG": _reference_names("unet", atk["netG"]), "clean_model": atk["clean_model"],
                "optimizerC": atk["optimizerC"], **scalars}, f"{ref_dir}/smoke_imported_atk.pth.tar")
    for args in (["--kind", "frequency", "--src", f"{ref_dir}/cifar10_original_detector.pth.tar",
                  "--F_checkpoints", f"{workdir}/F_imported"],
                 ["--kind", "attack", "--src", f"{ref_dir}/smoke_imported_atk.pth.tar", "--checkpoints", workdir]):
        proc = subprocess.run([sys.executable, "-m", "combat_tpu_torch.checkpoint.torch_import", *args],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise SystemExit(f"phase 5ze: the importer failed: {proc.stderr[-2000:]}")
    got_F = torch.load(f"{workdir}/F_imported/cifar10/original/cifar10_original_detector.pt", weights_only=True)
    got = torch.load(f"{workdir}/smoke_imported_atk/cifar10/cifar10_smoke_imported_atk.pt", weights_only=True)
    pairs = [("detector", got_F["netC"], detector["netC"])] + [(k, got[k], atk[k]) for k in ("netC", "netG",
                                                                                             "clean_model")]
    for what, a, b in pairs:
        if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in b):
            raise SystemExit(f"phase 5ze: the imported {what} differs from the original")
    if set(got) != {"netC", "netG", "clean_model", *scalars} or any(got[k] != v for k, v in scalars.items()):
        raise SystemExit(f"phase 5ze: the imported attack holds {sorted(got)}")
    tk.reset_launch_counts()
    evals = [final_eval.main(common + ["--synthetic_size", "1024", "--load_checkpoint_clean", "smoke_vic_clean",
                                       "--load_checkpoint", name])
             for name in ("smoke_atk_clean", "smoke_imported_atk")]
    counts = dict(tk.LAUNCHES)
    if counts != dict(zip(KERNEL_NAMES, IMPORTED)):
        raise SystemExit(f"phase 5ze launched {counts}, predicted {dict(zip(KERNEL_NAMES, IMPORTED))}")
    if evals[0] != evals[1]:
        raise SystemExit(f"phase 5ze: eval on the imported attack {evals[1]}, on the original {evals[0]}")
    print(f"  5ze: imported detector and attack equal the originals; eval on both: {evals[0]}", flush=True)
    _phase("5ze torch_import (reference .pth.tar) and eval", t0)
    return counts


# Phase 5zf: the entry points over NCCL at world size 1.  Each stage runs
# with --multihost and a coordinator on this host (one process, rank 0 of 1)
# and again with the same flags without it: 256 images at bs 128 (2 steps,
# then one eval batch of the 51 test rows) on phase 3's clean checkpoint, at
# full width with the committed cifar10 detector.  World size 1 takes the
# one-process code (no shard; no collective but the group's first meeting),
# so the two runs are held to each other exactly, with cuDNN deterministic
# for the phase, except the generator stage: the backward of the UNet's
# bilinear upsampling adds with atomics on CUDA, in any order, so G's first
# update differs by float32 roundings, and the second step's C-step sees
# G's output through them.  Its C and G are held to 1e-5 (a first card run
# gave 2.5e-6 for C), and the stage runs a third time without --multihost,
# whose distance from the first is printed beside: the card's own spread.
# The victims and evals are exact: both arms load the first generator (each
# eval its arm's victim), and G runs there without a gradient.  Launches of each arm: the
# generator 2 x (K1 2, K2 1) + K1 for the eval batch (+ the grid), the victim
# 2 K1 + 1, the eval 1.
ZF_STAGES = (  # (stage, entry point, saving prefix or None, flags, arms, (K1, K2, K3) of one arm)
    ("generator", "train_generator", "atk", ["--load_checkpoint_clean", "smoke_clean"], ("zf_", "zfmh_", "zfre_"),
     (2 * 2 + 1, 2, 0)),
    ("victim", "train_victim", "vic", ["--load_checkpoint", "zf_atk_clean"], ("zf_", "zfmh_"), (2 + 1, 0, 0)),
    ("eval", "eval", None, ["--load_checkpoint_clean", "{arm}vic_clean", "--load_checkpoint", "zf_atk_clean"],
     ("zf_", "zfmh_"), (1, 0, 0)),
)
ZF_NONDETERMINISTIC = {"generator": 1e-5}  # C and G of the stage (see above)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _max_diff(a: dict, b: dict, scaled: bool = False, keep=lambda key: True) -> float:
    """The largest |a - b| (``scaled``: |a - b| / (1 + |b|)) over the
    floating tensors of two state dicts of the same keys (those ``keep``
    accepts)."""
    if a.keys() != b.keys():
        raise SystemExit(f"state dicts with different keys: {sorted(a.keys() ^ b.keys())}")
    return max((float(((a[k].float() - b[k].float()).abs() / (1 + scaled * b[k].float().abs())).max())
                for k in a if a[k].is_floating_point() and keep(k)), default=0.0)


def _update_ratio(a: dict, b: dict, init: dict, keep) -> float:
    """||a - b|| / ||b - init|| over the tensors of the state dicts that
    ``keep`` accepts: how far two runs' parameters are apart against how
    far the run moved them."""
    keys = [k for k in b if b[k].is_floating_point() and keep(k)]
    gap = sum(float((a[k].float() - b[k].float()).pow(2).sum()) for k in keys) ** 0.5
    moved = sum(float((b[k].float() - init[k].float()).pow(2).sum()) for k in keys) ** 0.5
    return gap / moved


def nccl_world_one(common, workdir) -> dict:
    """Phase 5zf (see ZF_STAGES): each stage without and with --multihost
    over NCCL at world size 1, held to each other; returns the launches."""
    import importlib

    import torch

    from combat_tpu_torch.ops import trigger_kernels as tk

    t0 = time.perf_counter()
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    tk.reset_launch_counts()
    shown = {}
    try:
        for stage, entry, prefix, flags, arms, _ in ZF_STAGES:
            results = {}
            for arm in arms:
                world = (["--multihost", "--coordinator_address", f"127.0.0.1:{_free_port()}", "--num_processes",
                          "1", "--process_id", "0"] if arm == "zfmh_" else [])
                args = common + ["--synthetic_size", "256"] + [f.format(arm=arm) for f in flags] + world
                ckpt = {}
                if prefix:
                    args += ["--saving_prefix", f"{arm}{prefix}"]
                out = importlib.import_module(f"combat_tpu_torch.cli.{entry}").main(args)
                if prefix:
                    ckpt = check_checkpoint(f"{workdir}/{arm}{prefix}_clean/cifar10/cifar10_{arm}{prefix}_clean.pt")
                results[arm] = (out, ckpt)
            (out, ckpt), (out_mh, ckpt_mh) = results["zf_"], results["zfmh_"]
            if out != out_mh:
                raise SystemExit(f"phase 5zf {stage}: --multihost at world size 1 printed {out_mh}, without it {out}")
            diffs = {net: _max_diff(ckpt[net], ckpt_mh[net]) for net in ("netC", "netG") if net in ckpt}
            for net, d in diffs.items():
                if not d <= ZF_NONDETERMINISTIC.get(stage, 0.0):
                    raise SystemExit(f"phase 5zf {stage}: {net} differs by {d} with --multihost at world size 1")
            shown[stage] = {"metrics": out, "max_param_diff": diffs}
            if "zfre_" in results:
                again = results["zfre_"][1]
                shown[stage]["same_flags_twice"] = {net: _max_diff(ckpt[net], again[net]) for net in diffs}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    counts = dict(tk.LAUNCHES)
    predicted = [0, 0, 0]
    for _, entry, _, flags, arms, p in ZF_STAGES:
        predicted = [a + len(arms) * b for a, b in zip(predicted, with_grid(entry, flags, p))]
    if counts != dict(zip(KERNEL_NAMES, predicted)):
        raise SystemExit(f"phase 5zf launched {counts}, predicted {dict(zip(KERNEL_NAMES, predicted))}")
    print(f"  5zf: NCCL at world size 1 equals one process: {json.dumps(shown)}", flush=True)
    _phase("5zf train_generator, train_victim, eval (--multihost, NCCL, world size 1)", t0)
    return counts


# Phase 5zg: --remat step through the entry point.  The cifar10 generator
# stage at 256 images (2 steps at bs 128, then one eval batch of 51 rows) on
# phase 3's clean model runs with --remat step, and again without it (twice:
# the second run prints the card's own spread), with cuDNN deterministic and
# the save gates open (2 steps can score 0 on the test rows).
# A checkpointed step recomputes the G-step loss forward in its backward, so
# the trigger's forward kernel runs once more: K1 3 and K2 1 a step (2 and 1
# without remat), plus one K1 for the eval batch and one for the grid.  The
# recompute repeats the forward's arithmetic; only the backward of the UNet
# upsampling adds with atomics, as in 5zf, so C and G are held to 5zf's
# 1e-5 and the eval's metrics exactly.
ZG_ARMS = (("zg_", ["--remat", "step"], (2 * 3 + 1, 2, 0)), ("zgn_", [], (2 * 2 + 1, 2, 0)),
           ("zgre_", [], (2 * 2 + 1, 2, 0)))
ZG_TOL = ZF_NONDETERMINISTIC["generator"]


def _remat_arms(common, workdir, total: dict) -> dict:
    """Each arm of 5zg with the launch counts set to 0 before it and held
    after it; their launches added to ``total``; (metrics, checkpoint) by arm."""
    from combat_tpu_torch.cli import train_generator
    from combat_tpu_torch.ops import trigger_kernels as tk

    runs = {}
    for arm, flags, predicted in ZG_ARMS:
        tk.reset_launch_counts()
        args = common + ["--synthetic_size", "256", "--load_checkpoint_clean", "smoke_clean", "--saving_prefix",
                         f"{arm}atk"] + flags
        out = train_generator.main(args)
        counts = dict(tk.LAUNCHES)
        expected = dict(zip(KERNEL_NAMES, with_grid("train_generator", args, predicted)))
        if counts != expected:
            raise SystemExit(f"phase 5zg {arm}: launched {counts}, predicted {expected}")
        for k in KERNEL_NAMES:
            total[k] += counts[k]
        runs[arm] = (out, check_checkpoint(f"{workdir}/{arm}atk_clean/cifar10/cifar10_{arm}atk_clean.pt"))
    return runs


def remat_generator(common, workdir) -> dict:
    """Phase 5zg (see ZG_ARMS): the generator stage with and without
    --remat step; returns the launches of the three runs."""
    import torch

    t0 = time.perf_counter()
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    total = {k: 0 for k in KERNEL_NAMES}
    try:
        with _save_gates_open():
            runs = _remat_arms(common, workdir, total)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    (out, ckpt), (out_n, ckpt_n), (_, again) = runs["zg_"], runs["zgn_"], runs["zgre_"]
    diffs = {net: _max_diff(ckpt[net], ckpt_n[net]) for net in ("netC", "netG")}
    spread = {net: _max_diff(again[net], ckpt_n[net]) for net in ("netC", "netG")}
    print(f"  5zg: --remat step against none: metrics {out} / {out_n}, max |param diff| {diffs} (tolerance {ZG_TOL}); "
          f"none twice: {spread}; launches {json.dumps(total)}", flush=True)
    if out != out_n or not all(d <= ZG_TOL for d in diffs.values()):
        raise SystemExit(f"phase 5zg: --remat step gave {out} and {diffs}, none {out_n}")
    _phase("5zg train_generator --remat step against none", t0)
    return total


# Phase 6-dp: two ranks on one card.  chip_smoke.py spawns two processes on
# cuda:0 in a gloo group of their own (gloo runs broadcast and all_reduce on
# CUDA tensors; NCCL takes one rank per card).  Each runs, through
# train/loop.py at global bs 128 on 259 rows (2 full batches and a ragged
# tail of 3: 2 rows for rank 0, 1 for rank 1), one alternated epoch, one
# attack eval (3 padded batches of 64 + 64 rows) and one victim epoch at
# full width (PreActResNet18, UNet nf 64, the committed cifar10 detector),
# from one set of seeded weights; this process runs the same epochs alone on
# the card, twice.  Launches of each rank and of each one-process run: 3 alternated
# steps x (K1 2, K2 1) + 3 eval batches x K1 + 3 victim steps x K1.  The two
# ranks' parameters and BatchNorm statistics must be equal bit for bit
# (each applies the same summed gradient and the same global statistics).
# Against the one process the learning rates are 1e-4 (at 0.01 float32
# reorderings are amplified chaotically, as tests/test_torch_data_parallel.py
# measures on the CPU), and the tolerances come from the card's own spread:
# this process runs the epochs twice, the second time with cuDNN
# deterministic (other convolution algorithms, as the ranks' half batches
# get), and prints how far apart the two are.  On the first card runs
# (NVIDIA H100 80GB HBM3, 700.00 W) that spread reached 3.3% (C)
# and 5.2% (G) of the epochs' update ||one - initial||, BatchNorm running
# statistics 3.6e-5 of (1 + |value|) and the victim's loss 1.8e-5 relative,
# and the ranks sat at 3.8-13% of the update, 7.3e-5 and 3.5e-5: the
# atomics of the UNet upsampling's backward and cuDNN's choice of
# algorithm make a float32 run differ from itself by that much, and the
# ranks' half batches add no more.  So the ranks' parameters are held to
# 25% of the update (a gradient off by a factor, one rank's or the mean
# where the sum belongs, gives >= 50%), the running statistics to 5e-4
# (1 + |value|) (a shard's own statistics in place of the global batch's
# would differ by ~1e-2), the losses to 2e-4 relative, the counts exactly.
DP_ROWS, DP_BS, DP_LR = 259, 128, 1e-4
DP_UPDATE_TOL, DP_STATS_TOL, DP_LOSS_TOL = 0.25, 5e-4, 2e-4
DP_PREDICTED = (3 * 2 + 3 + 3, 3, 0)


def _dp_setup(workdir) -> str:
    """The seeded weights and data of phase 6-dp, saved for the ranks."""
    import numpy as np
    import torch

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator

    cfg = apply_dataset_preset(Config())
    torch.manual_seed(6)
    models = {"C": get_classifier(cfg), "G": get_generator(cfg), "cm": get_classifier(cfg),
              "nf": get_frequency_detector(cfg)}
    sd = {k: m.state_dict() for k, m in models.items()}
    sd["nf"] = torch.load("defenses/frequency_based/checkpoints/cifar10/original/cifar10_original_detector.pt",
                          map_location="cpu", weights_only=True)["netC"]
    rng = np.random.default_rng(6)
    labels = rng.integers(0, 10, DP_ROWS)
    labels[::3] = 0  # a third target-class rows, so the C-step poisons some
    data = {"images": torch.from_numpy(rng.uniform(-1, 1, (DP_ROWS, 3, 32, 32)).astype(np.float32)),
            "labels": torch.from_numpy(labels), "poisoned": torch.from_numpy(rng.random(DP_ROWS) < 0.3)}
    path = f"{workdir}/dp_setup.pt"
    torch.save({"models": sd, "data": data}, path)
    return path


def _dp_epochs(setup: str, world) -> dict:
    """Phase 6-dp's epochs on ``world`` (None: this process alone), on
    cuda:0, through train/loop.py; their metrics, the models' states on
    the CPU, the launches, the first draws of the run's generator and the
    seconds."""
    import torch

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.ops import trigger_kernels as tk
    from combat_tpu_torch.train import (
        TrainState,
        eval_epoch,
        freeze,
        make_alternated_train_step,
        make_attack_eval_step,
        make_victim_train_step,
        metrics_to_host,
        multistep_lr,
        train_epoch_alternated,
        train_epoch_classifier,
    )
    from combat_tpu_torch.train.mesh import channel_shard, gather_full, replicate

    dev = torch.device("cuda", 0)
    cfg = apply_dataset_preset(Config(bs=DP_BS))
    saved = torch.load(setup, map_location="cpu", weights_only=True)
    C, G, cm, nf = get_classifier(cfg), get_generator(cfg), get_classifier(cfg), get_frequency_detector(cfg)
    for key, m in zip(("C", "G", "cm", "nf"), (C, G, cm, nf)):
        m.load_state_dict(saved["models"][key])
        m.to(dev)
        if world is not None:
            channel_shard(replicate(m, world), world)
    sched = multistep_lr(DP_LR, (100,), 0.1, 10)
    stateC, stateG = TrainState(C, sched, world), TrainState(G, sched, world)
    freeze(cm), freeze(nf)
    images, labels, poisoned = (saved["data"][k].to(dev) for k in ("images", "labels", "poisoned"))
    generator = torch.Generator(device=dev).manual_seed(0)
    probe = torch.rand(8, generator=torch.Generator(device=dev).manual_seed(0), device=dev).cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tk.reset_launch_counts()
    out = {"alternated": metrics_to_host(train_epoch_alternated(
        make_alternated_train_step(cfg, C, G), stateC, stateG, cm, nf, images, labels, generator, DP_BS, world=world))}
    out["eval"] = metrics_to_host(eval_epoch(make_attack_eval_step(cfg, C, G), (cm, nf), images, labels, DP_BS,
                                             world=world, generator=generator))
    freeze(G)
    out["victim"] = metrics_to_host(train_epoch_classifier(
        make_victim_train_step(cfg, C, G), stateC, images, labels, generator, DP_BS, poisoned=poisoned, world=world))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0

    def cpu(sd):
        return {k: v.cpu() for k, v in sd.items()}

    out.update(seconds=seconds, launches=dict(tk.LAUNCHES), probe=probe, C=cpu(gather_full(C)),
               G=cpu(gather_full(G)), local={"C": cpu(C.state_dict()), "G": cpu(G.state_dict())},
               resident=_resident_bytes({"C": C, "G": G, "cm": cm, "nf": nf},
                                        {"C": stateC.optimizer, "G": stateG.optimizer}))
    return out


def _resident_bytes(models: dict, optimizers: dict) -> dict:
    """The bytes a process holds of the models' parameters and buffers and
    of SGD's momentum, split into the tensors that a model axis of 2
    shards (``sharded_tensors``: halved on a rank of the 2 x 2 grid) and
    the rest."""
    from combat_tpu_torch.train.mesh import sharded_tensors

    out = {"sharded": 0, "whole": 0}
    for key, m in models.items():
        split = set(sharded_tensors(m, 2))
        for name, t in m.state_dict().items():
            out["sharded" if name in split else "whole"] += t.numel() * t.element_size()
        opt = optimizers.get(key)
        for name, p in m.named_parameters():
            buf = None if opt is None else opt.state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                out["sharded" if name in split else "whole"] += buf.numel() * buf.element_size()
    return out


def _dp_rank(rank: int, setup: str, folder: str, threads: int, world_size: int = 2, n_model: int = 1) -> None:
    """One rank of phase 6-dp (or, on a grid of ``n_model`` > 1, of 6-tp):
    joins the gloo group of the ``file://`` store in ``folder`` on cuda:0,
    checks that the trigger wrappers launch nothing on an empty batch, runs
    :func:`_dp_epochs` and saves what it returns."""
    import datetime

    import torch

    from combat_tpu_torch.ops import trigger_kernels as tk
    from combat_tpu_torch.train.mesh import join

    faulthandler.dump_traceback_later(600, exit=True)  # a hung rank ends itself
    torch.set_num_threads(threads)  # the two ranks share the host's cores
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    world = join(dev, "gloo", timeout=datetime.timedelta(minutes=3), init_method=f"file://{folder}/store",
                 world_size=world_size, rank=rank, n_model=n_model)
    try:
        tk.reset_launch_counts()
        empty = torch.zeros((0, 3, 32, 32), device=dev)
        taps, Dc = torch.ones(3, device=dev) / 3, tk.truncated_dct(32, RATIO, dev)
        shapes = [tuple(t.shape) for t in (*tk.fused_trigger_fwd(empty, empty, taps, Dc, NOISE_RATE),
                                           *tk.fused_trigger_bwd(empty, empty, taps, Dc, NOISE_RATE),
                                           tk.low_freq_planes(empty, RATIO))]
        if shapes != [(0, 3, 32, 32)] * 5 or any(tk.LAUNCHES.values()):
            raise SystemExit(f"6-dp/6-tp rank {rank}: the wrappers on 0 planes gave {shapes}, launched {tk.LAUNCHES}")
        out = _dp_epochs(setup, world)
    finally:
        world.close()
    torch.save(out, f"{folder}/rank{rank}.pt")


def two_ranks_one_card() -> tuple:
    """Phase 6-dp (see DP_PREDICTED): two gloo ranks on cuda:0 and this
    process alone, then phase 6-tp (:func:`grid_on_one_card`) against the
    same one-process runs; returns each phase's launches by run."""
    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    folder = tempfile.mkdtemp(prefix="combat_smoke_dp_")
    try:
        setup = _dp_setup(folder)
        os.makedirs(f"{folder}/dp")
        mp.spawn(_dp_rank, args=(setup, f"{folder}/dp", max(1, torch.get_num_threads() // 2)), nprocs=2)
        ranks = [torch.load(f"{folder}/dp/rank{r}.pt", weights_only=False) for r in range(2)]
        one = _dp_epochs(setup, None)
        cudnn = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            again = _dp_epochs(setup, None)
        finally:
            torch.backends.cudnn.deterministic = cudnn
        init = torch.load(setup, weights_only=True)["models"]
        counts = _hold_dp(ranks, one, again, init, t0)
        return counts, grid_on_one_card(setup, folder, one, again, init)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def _gaps(a: dict, b: dict, init: dict):
    """(||a - b|| / ||b - initial|| of C and G, the statistics' largest
    |a - b| / (1 + |b|), the losses' largest relative difference) of two
    runs of :func:`_dp_epochs`."""
    def stats(key):
        return "running_" in key

    def params(key):
        return not stats(key) and "num_batches" not in key

    ratio = {net: _update_ratio(a[net], b[net], init[net], params) for net in ("C", "G")}
    loss = max(abs(a[part][k] - v) / max(abs(v), 1e-12) for part in ("alternated", "eval", "victim")
               for k, v in b[part].items() if not k.endswith(("correct", "sample", "bd_ba", "bd_asr")))
    return ratio, max(_max_diff(a[net], b[net], scaled=True, keep=stats) for net in ("C", "G")), loss


def _hold_counts(phase: str, ranks: list, one: dict) -> None:
    """The ranks' summed metrics equal each other, and their counts the one
    process's."""
    for part in ("alternated", "eval", "victim"):
        if any(r[part] != ranks[0][part] for r in ranks):
            raise SystemExit(f"phase {phase}: the ranks' summed {part} metrics differ")
        for k, v in one[part].items():
            if k.endswith(("correct", "sample", "bd_ba", "bd_asr")) and ranks[0][part][k] != v:
                raise SystemExit(f"phase {phase} {part}: {k} {ranks[0][part][k]} on the ranks, {v} in one process")


def _hold_dp(ranks, one, again, init, t0) -> dict:
    """Phase 6-dp's checks and line; returns its launches by run."""
    import torch

    counts = {"rank0": ranks[0]["launches"], "rank1": ranks[1]["launches"], "one_process": one["launches"],
              "one_process_again": again["launches"]}
    for who, c in counts.items():
        if c != dict(zip(KERNEL_NAMES, DP_PREDICTED)):
            raise SystemExit(f"phase 6-dp: {who} launched {c}, predicted {dict(zip(KERNEL_NAMES, DP_PREDICTED))}")
    if not all(torch.equal(r["probe"], one["probe"]) for r in ranks):
        raise SystemExit("phase 6-dp: the ranks' generators drew other numbers from the same seed than this process")
    between = max(_max_diff(ranks[0][net], ranks[1][net]) for net in ("C", "G"))
    if between != 0.0:
        raise SystemExit(f"phase 6-dp: the two ranks' parameters differ by {between}")
    vs_one = max(_max_diff(ranks[0][net], one[net], keep=lambda k: "running_" not in k and "num_batches" not in k)
                 for net in ("C", "G"))
    (ratio, vs_one_stats, worst_loss), spread = _gaps(ranks[0], one, init), _gaps(again, one, init)
    _hold_counts("6-dp", ranks, one)
    print(f"  6-dp: ranks' max |param diff| {between}; vs one process: max |param diff| {vs_one:.3e}, "
          f"||diff|| / ||update|| C {ratio['C']:.3e} G {ratio['G']:.3e} (tolerance {DP_UPDATE_TOL}), BatchNorm "
          f"statistics max |diff| / (1 + |value|) {vs_one_stats:.3e} ({DP_STATS_TOL}), max loss rel diff "
          f"{worst_loss:.3e} ({DP_LOSS_TOL}); the card's own spread (one process again, cuDNN deterministic): "
          f"C {spread[0]['C']:.3e} G {spread[0]['G']:.3e}, statistics {spread[1]:.3e}, losses {spread[2]:.3e}; "
          f"seconds rank0 {ranks[0]['seconds']:.3f}, rank1 {ranks[1]['seconds']:.3f}, one process "
          f"{one['seconds']:.3f}; launches {json.dumps(counts)}", flush=True)
    if not (max(ratio.values()) <= DP_UPDATE_TOL and vs_one_stats <= DP_STATS_TOL and worst_loss <= DP_LOSS_TOL):
        raise SystemExit(f"phase 6-dp: two ranks and one process disagree: params {ratio} of the update, "
                         f"statistics {vs_one_stats}, losses {worst_loss}")
    _phase("6-dp two gloo ranks on cuda:0 vs one process", t0)
    return counts


# Phase 6-tp: the 2-D (data, model) layout on one card.  Four processes on
# cuda:0 in a gloo group form the 2 x 2 grid (train/mesh.py: rank r is data
# index r // 2, model index r % 2) and run 6-dp's epochs (an alternated
# epoch, an attack eval and a victim epoch at global bs 128 on 259 rows, lr
# 1e-4, full width) with C, G, the clean model and the detector
# channel-sharded over the model axis; they are held to 6-dp's two
# one-process runs.  Each rank runs every step on its data index's rows, so
# it launches what a 6-dp rank launches (TP_PREDICTED).  The ranks of one
# model index hold bit-equal blocks and all four bit-equal replicated
# tensors (the UNet's 3-channel output conv is the one replicated
# parameter: its gradient is computed alike on the ranks of a data index
# and summed over the data axis).  Against one process the tolerances are
# 6-dp's, set from its measured range: 25% of the update for the
# parameters, 5e-4 (1 + |value|) for the running statistics, 2e-4 relative
# for the losses, the counts exactly.  Each rank prints the bytes it holds
# of parameters, buffers and momentum, the sharded share against one
# process's: half.
TP_UPDATE_TOL, TP_STATS_TOL, TP_LOSS_TOL = DP_UPDATE_TOL, DP_STATS_TOL, DP_LOSS_TOL
TP_PREDICTED = DP_PREDICTED


def grid_on_one_card(setup: str, folder: str, one: dict, again: dict, init: dict) -> dict:
    """Phase 6-tp (see TP_PREDICTED): the 2 x 2 grid of four gloo ranks on
    cuda:0 against 6-dp's one-process runs; returns each rank's launches."""
    import torch
    import torch.multiprocessing as mp

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_generator
    from combat_tpu_torch.train.mesh import sharded_tensors

    t0 = time.perf_counter()
    os.makedirs(f"{folder}/tp")
    mp.spawn(_dp_rank, args=(setup, f"{folder}/tp", max(1, torch.get_num_threads() // 4), 4, 2), nprocs=4)
    ranks = [torch.load(f"{folder}/tp/rank{r}.pt", weights_only=False) for r in range(4)]
    counts = {f"rank{r}": ranks[r]["launches"] for r in range(4)}
    for who, c in counts.items():
        if c != dict(zip(KERNEL_NAMES, TP_PREDICTED)):
            raise SystemExit(f"phase 6-tp: {who} launched {c}, predicted {dict(zip(KERNEL_NAMES, TP_PREDICTED))}")
    cfg = apply_dataset_preset(Config(device="cpu"))
    split = {"C": set(sharded_tensors(get_classifier(cfg), 2)), "G": set(sharded_tensors(get_generator(cfg), 2))}
    replicated = []
    for net in ("C", "G"):
        for k, v in ranks[0]["local"][net].items():
            peers = [r for i, r in enumerate(ranks) if k not in split[net] or i % 2 == 0]
            if not all(torch.equal(r["local"][net][k], v) for r in peers):
                raise SystemExit(f"phase 6-tp: {net}.{k} differs between the ranks that hold it")
            if k not in split[net] and v.is_floating_point():
                replicated.append(f"{net}.{k}")
        if any(not torch.equal(r[net][k], ranks[0][net][k]) for r in ranks for k in ranks[0][net]):
            raise SystemExit(f"phase 6-tp: the ranks gathered other {net}")
    _hold_counts("6-tp", ranks, one)
    (ratio, stats, loss), spread = _gaps(ranks[0], one, init), _gaps(again, one, init)
    bytes_one = one["resident"]
    shares = [r["resident"]["sharded"] / bytes_one["sharded"] for r in ranks]
    print(f"  6-tp: blocks equal on the ranks of a model index, replicated tensors ({', '.join(replicated)}) on all "
          f"four, bit for bit; vs one process: ||diff|| / ||update|| C {ratio['C']:.3e} G {ratio['G']:.3e} "
          f"(tolerance {TP_UPDATE_TOL}), BatchNorm statistics {stats:.3e} ({TP_STATS_TOL}), losses {loss:.3e} "
          f"({TP_LOSS_TOL}); the card's own spread: C {spread[0]['C']:.3e} G {spread[0]['G']:.3e}, statistics "
          f"{spread[1]:.3e}, losses {spread[2]:.3e}; resident bytes (sharded + whole) one process "
          f"{bytes_one['sharded']} + {bytes_one['whole']}, ranks "
          f"{[(r['resident']['sharded'], r['resident']['whole']) for r in ranks]}, sharded share {shares}; "
          f"seconds {[round(r['seconds'], 3) for r in ranks]}; launches {json.dumps(counts)}", flush=True)
    if any(share != 0.5 for share in shares):
        raise SystemExit(f"phase 6-tp: a rank holds {shares} of the sharded tensors, not half")
    if not (max(ratio.values()) <= TP_UPDATE_TOL and stats <= TP_STATS_TOL and loss <= TP_LOSS_TOL):
        raise SystemExit(f"phase 6-tp: the grid and one process disagree: params {ratio} of the update, "
                         f"statistics {stats}, losses {loss}")
    _phase("6-tp 2 x 2 grid of gloo ranks on cuda:0 vs one process", t0)
    return counts


# Phase 6-mc: ``python -m combat_tpu_torch.multichip 4 --backend gloo``, the
# port of the JAX dryrun, on cuda:0: four ranks run the full alternated step
# at cifar10 width on bs 8, data-parallel, then on the 2 x 2 grid; each rank
# launches K1 2 and K2 1 a step, so 16 and 8 over the ranks and the two steps.
# Its ranks spend most of their time starting, so it runs beside phase 6,
# which checks values and times nothing; its launches are its own processes'.
MC_PREDICTED = (2 * 4 * 2, 2 * 4 * 1, 0)


def start_multichip() -> tuple:
    """Phase 6-mc's process, started; with its start time."""
    return subprocess.Popen([sys.executable, "-m", "combat_tpu_torch.multichip", "4", "--backend", "gloo"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True), time.perf_counter()


def stop_multichip(started: tuple) -> None:
    """Ends phase 6-mc's process and its ranks (its own process group)."""
    import signal

    with contextlib.suppress(ProcessLookupError):
        os.killpg(started[0].pid, signal.SIGKILL)
    started[0].wait()


def multichip_on_one_card(started: tuple) -> dict:
    """Phase 6-mc (see MC_PREDICTED): waits for :func:`start_multichip`'s
    process; its two lines, their losses and its launches as the ranks
    summed them."""
    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        stop_multichip(started)
        raise SystemExit("phase 6-mc: multichip did not end within 600 s")
    lines = [line for line in stdout.splitlines() if line.startswith("dryrun_multichip")]
    print("\n".join(f"  6-mc: {line}" for line in lines), flush=True)
    if proc.returncode != 0 or len(lines) != 3:
        raise SystemExit(f"phase 6-mc: multichip exited {proc.returncode}: {stdout[-2000:]}{stderr[-3000:]}")
    counts = json.loads(lines[2].split("launches ", 1)[1])
    if counts != dict(zip(KERNEL_NAMES, MC_PREDICTED)):
        raise SystemExit(f"phase 6-mc launched {counts}, predicted {dict(zip(KERNEL_NAMES, MC_PREDICTED))}")
    _phase("6-mc multichip 4 --backend gloo (started with phase 6)", t0)
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.parse_args(argv)
    faulthandler.dump_traceback_later(HANG_S, exit=True)
    t_start = time.perf_counter()

    # The run uses one card; show torch only that one, so the device count
    # in the result line is the count the run used.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0] or "0"
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from combat_tpu_torch.cli import eval as final_eval
    from combat_tpu_torch.cli import train_clean_classifier, train_generator, train_victim
    from combat_tpu_torch.ops import trigger_kernels as tk

    # 1. the card, then the build
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    tb = time.perf_counter()
    tk.build()
    print(f"  build: {time.perf_counter() - tb:.3f} s (one nvcc call)", flush=True)
    print("\n".join(f"  {line.strip()}" for line in tk.BUILD_LOG.splitlines()
                    if any(w in line for w in ("Compiling entry", "registers", "smem", "spill"))))
    _phase("1 card + build", t0)

    # 2. kernels against their plain versions, and their times
    t0 = time.perf_counter()
    rows = compare_kernels()
    _phase("2 kernels vs plain", t0)

    workdir = tempfile.mkdtemp(prefix="combat_smoke_")
    try:
        common = ["--device", "cuda", "--dataset", "cifar10", "--synthetic_data", "--bs", "128",
                  "--n_iters", "1", "--checkpoints", workdir]
        tk.reset_launch_counts()  # the main path's launches start here
        per_phase = {}

        # 3. clean classifier: 1024 images = 8 steps, then eval
        t0 = time.perf_counter()
        train_clean_classifier.main(common + ["--synthetic_size", "1024", "--saving_prefix", "smoke_clean"])
        check_checkpoint(f"{workdir}/smoke_clean/cifar10/cifar10_smoke_clean.pt")
        per_phase["3"] = dict(tk.LAUNCHES)
        _phase("3 train_clean_classifier", t0)

        # 4. alternated generator training, fused trigger (K1/K2): 8 steps + eval
        t0 = time.perf_counter()
        best = train_generator.main(common + ["--synthetic_size", "1024", "--saving_prefix", "smoke_atk",
                                              "--load_checkpoint_clean", "smoke_clean"])
        atk = check_checkpoint(f"{workdir}/smoke_atk_clean/cifar10/cifar10_smoke_atk_clean.pt")
        if atk["F_detector_loaded"] is not True:
            raise SystemExit("phase 4 ran without the committed cifar10 frequency detector")
        per_phase["4"] = dict(tk.LAUNCHES)
        _phase("4 train_generator (pallas_trigger)", t0)

        # 5. the same step with the low-pass kernel K3 + clamp + blur: 2 steps + eval
        t0 = time.perf_counter()
        best_k3 = train_generator.main(common + ["--synthetic_size", "256", "--saving_prefix", "smoke_k3",
                                                 "--load_checkpoint_clean", "smoke_clean",
                                                 "--pallas_trigger", "false", "--pallas_lowfreq", "true"])
        check_checkpoint(f"{workdir}/smoke_k3_clean/cifar10/cifar10_smoke_k3_clean.pt")
        launches = dict(tk.LAUNCHES)  # read right after the main path
        per_phase["5"] = launches
        _phase("5 train_generator (pallas_trigger false, pallas_lowfreq true)", t0)

        # 5b. the ATen route, no trigger kernel: 2 steps + eval
        t0 = time.perf_counter()
        tk.reset_launch_counts()
        best_aten = train_generator.main(common + ["--synthetic_size", "256", "--saving_prefix", "smoke_aten",
                                                   "--load_checkpoint_clean", "smoke_clean",
                                                   "--pallas_trigger", "false", "--pallas_lowfreq", "false"])
        aten_launches = dict(tk.LAUNCHES)
        check_checkpoint(f"{workdir}/smoke_aten_clean/cifar10/cifar10_smoke_aten_clean.pt")
        _phase("5b train_generator (pallas_trigger false, pallas_lowfreq false)", t0)

        # 5c. the victim on phase 4's generator, fused trigger: 8 steps + eval
        t0 = time.perf_counter()
        tk.reset_launch_counts()
        victim = ["--load_checkpoint", "smoke_atk_clean"]
        best_vic = train_victim.main(common + victim + ["--synthetic_size", "1024", "--saving_prefix", "smoke_vic"])
        per_phase["5c"] = dict(tk.LAUNCHES)
        vic = check_checkpoint(f"{workdir}/smoke_vic_clean/cifar10/cifar10_smoke_vic_clean.pt")
        if vic["schedulerC"]["step"] != 8:
            raise SystemExit(f"phase 5c took {vic['schedulerC']['step']} steps, not 8")
        _phase("5c train_victim (pallas_trigger)", t0)

        # 5d. the victim with K3, then clamp and blur: 2 steps + eval
        t0 = time.perf_counter()
        tk.reset_launch_counts()
        best_vic_k3 = train_victim.main(common + victim + ["--synthetic_size", "256", "--saving_prefix", "smoke_vic3",
                                                           "--pallas_trigger", "false", "--pallas_lowfreq", "true"])
        per_phase["5d"] = dict(tk.LAUNCHES)
        check_checkpoint(f"{workdir}/smoke_vic3_clean/cifar10/cifar10_smoke_vic3_clean.pt")
        _phase("5d train_victim (pallas_trigger false, pallas_lowfreq true)", t0)

        # 5e. the final eval of 5c's victim with phase 4's generator
        t0 = time.perf_counter()
        tk.reset_launch_counts()
        final = final_eval.main(common + ["--synthetic_size", "1024", "--load_checkpoint_clean", "smoke_vic_clean",
                                          "--load_checkpoint", "smoke_atk_clean"])
        per_phase["5e"] = dict(tk.LAUNCHES)
        _phase("5e eval", t0)

        # 5f-5k. the attack variants, each with its own counts
        variant_launches = run_variant_phases(common, workdir)

        # 5l-5q. celeba and imagenet10 (the tiled kernels), each with its own counts
        large_launches = run_phases(workdir, LARGE_PHASES)

        # 5r-5t. --compute_dtype bfloat16, each with its own counts
        bf16_launches = run_phases(workdir, BF16_PHASES)

        # 5u-5w. the rest of the model registry, each with its own counts
        zoo_launches = run_phases(workdir, ZOO_PHASES)
        ensemble_stays_live()

        # 5x-5z. the defenses on the port's own checkpoints, each with its own counts
        defense_launches = run_defense_phases(workdir)

        # 5za-5zc. the extended zoo, each with its own counts
        zoo_extra_launches = run_phases(workdir, ZOO_EXTRA_PHASES)
        efficientnet_stops(workdir)
        zoo_extra_launches.update(run_defense_phases(workdir, ZOO_EXTRA_DETECTOR_PHASES))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zoo_extra_launches.update(run_phases(workdir, ZOO_EXTRA_224_PHASES))
        print(f"  5zc imagenet10 mobilenet clean and generator: max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)

        # 5zd-5ze. the profiled generator with its grids, and the reference's checkpoints imported
        launches_5zd_5ze = {"5zd": profiled_generator(common, workdir), "5ze": imported_checkpoints(common, workdir)}

        # 5zf. the entry points over NCCL at world size 1, held to one process
        launches_5zd_5ze["5zf"] = nccl_world_one(common, workdir)

        # 5zg. the generator stage with --remat step, held to the same flags without it
        launches_5zd_5ze["5zg"] = remat_generator(common, workdir)

        # 5zh-5zi. the variants at celeba and imagenet10, each with its own counts; the
        # K1/K2 and ATen routes of two variant steps at 224 px
        variant_large_launches = run_phases(workdir, VARIANT_LARGE_PHASES)
        t0 = time.perf_counter()
        parity = route_parity(max(rows[k]["max_abs_err"] for k in ("fused_trigger_fwd", "fused_trigger_bwd")))
        _phase("5zi route parity at 224 px (K1/K2 vs ATen)", t0)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if any(aten_launches.values()):
        raise SystemExit(f"the ATen route launched trigger kernels: {aten_launches}")
    for metrics in (best, best_k3, best_aten, best_vic, best_vic_k3):
        if not all(v == v and abs(v) < float("inf") for v in metrics.values()):
            raise SystemExit(f"non-finite eval metrics: {metrics}")
    if not all(0.0 <= v <= 100.0 for v in final):  # also false for NaN
        raise SystemExit(f"eval's Clean Acc, Bd BA, Bd ASR are not percentages: {final}")
    print(f"  launches after phases 3, 4, 5 and in 5c, 5d, 5e: {json.dumps(per_phase)}; "
          f"in phase 5b: {json.dumps(aten_launches)}", flush=True)
    # G is frozen in the victim and eval stages: K1 runs, K2 never does
    expect = {"5c": ("fused_trigger_fwd", ("fused_trigger_bwd", "low_freq")),
              "5d": ("low_freq", ("fused_trigger_fwd", "fused_trigger_bwd")),
              "5e": ("fused_trigger_fwd", ("fused_trigger_bwd", "low_freq"))}
    for ph, (used, unused) in expect.items():
        if per_phase[ph][used] == 0 or any(per_phase[ph][k] for k in unused):
            raise SystemExit(f"phase {ph} launched {per_phase[ph]}: expected {used} only")
    print(f"  launches in phases 5f-5k (each as predicted): {json.dumps(variant_launches)}", flush=True)
    print(f"  launches in phases 5l-5q (each as predicted): {json.dumps(large_launches)}", flush=True)
    print(f"  launches in phases 5r-5t (bfloat16, each as predicted): {json.dumps(bf16_launches)}", flush=True)
    print(f"  launches in phases 5u-5w (each as predicted): {json.dumps(zoo_launches)}", flush=True)
    print(f"  launches in phases 5x-5z (each as predicted): {json.dumps(defense_launches)}", flush=True)
    print(f"  launches in phases 5za-5zc (each as predicted): {json.dumps(zoo_extra_launches)}", flush=True)
    print(f"  launches in phases 5zd-5zg (each as predicted): {json.dumps(launches_5zd_5ze)}", flush=True)
    print(f"  launches in phases 5zh-5zi (each as predicted): {json.dumps(variant_large_launches)}", flush=True)
    print(json.dumps({"route_parity_224": parity}), flush=True)
    later = (*variant_launches.values(), *large_launches.values(), *bf16_launches.values(), *zoo_launches.values(),
             *defense_launches.values(), *zoo_extra_launches.values(), *launches_5zd_5ze.values(),
             *variant_large_launches.values())
    launches = {k: n + sum(per_phase[ph][k] for ph in expect) + sum(c[k] for c in later)
                for k, n in launches.items()}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise SystemExit(f"kernels never launched on the main path: {missing}")

    # 6. the card's step against the CPU's (6-mc's dryrun starts beside it)
    multichip = start_multichip()
    try:
        t0 = time.perf_counter()
        step_agreement()
        variant_step_agreement()
        large_step_agreement()
        zoo_step_agreement()
        zoo_extra_step_agreement()
        detector_step_agreement()
        efficientnet_detector_step_agreement()
        bf16_step_agreement()
        _phase("6 card vs CPU step", t0)
    except BaseException:
        stop_multichip(multichip)
        raise

    # 6-mc. the dryrun; 6-dp, 6-tp. two gloo ranks on cuda:0 through train/loop.py, held to each
    # other and to one process, then the 2 x 2 grid of four, held to the same one-process runs
    mc_launches = multichip_on_one_card(multichip)
    dp_launches, tp_launches = two_ranks_one_card()
    launches = {k: n + sum(c[k] for c in (*dp_launches.values(), *tp_launches.values(), mc_launches))
                for k, n in launches.items()}

    # 7. the steady-state step
    t0 = time.perf_counter()
    print(json.dumps({"step": step_times()}), flush=True)
    print(json.dumps({"defenses": defense_times()}), flush=True)
    _phase("7 steady-state steps", t0)

    for name, row in rows.items():
        row["launches"] = launches[name]
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(f"[total] {time.perf_counter() - t_start:.3f} s", flush=True)
    faulthandler.cancel_dump_traceback_later()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
