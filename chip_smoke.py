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
     split into products, K1's one-pass blur and K2's band passes (the
     ``h224`` entry of each kernel's row); the tiled kernels are held at
     257 and 300 px too, where the products read the projector's depth in
     windows;
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
  6. one alternated step and one victim step at full width on the card
     against the same step on the CPU, from the same weights and draws, one
     input-aware and one multilabel step (bs 32), and one alternated step
     at 96 px (ResNet18, bs 4) where the tiled K1/K2 run inside the step;
     then the alternated and victim steps in bfloat16 on the card and on
     the CPU on six seeds, held by the gap criterion of
     ``combat_tpu_torch/utils/gap.py`` with the card's float32 step as the
     yardstick;
  7. the steady-state alternated step at full width (bs 128), timed on the
     host clock around synchronised runs of 10 steps, on the three trigger
     routes (K1/K2, K3, ATen) and in both metric modes, the victim step
     on the K1 and ATen routes, and each variant's step on the K1/K2 route;
     then (5 steps each) the imagenet10 alternated step at 224 px, bs 32 on
     the K1/K2 and ATen routes with the K1/K2 step's peak device memory,
     the imagenet10 victim step, and the celeba alternated step (bs 128);
     all of it in float32, then in bfloat16, each row named by its dtype.
Then one JSON line of the kernels (launches on the main path, phases 3-5,
5c-5e, 5f-5k, 5l-5q and 5r-5t, errors, times, bounds) and, last,
``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when torch sees no CUDA device or the
package is missing; any failed check or phase raises.  A hang ends after
900 s as a traceback and a non-zero exit.
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
    224.  K1/K2 forward and backward with 3 and 5 taps (sigma 0.9: B^T !=
    B), K3 forward and through autograd.  Returns the largest error of
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
        for k in (3, 5):
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
    the kernels run) and in float32 FMA (``bound_f32_fma_ms``).  Returns a
    dict per kernel."""
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
        print(f"  {name} at {h} px, {planes} planes: {out[name]['ms']:.4f} ms (traced {traced}; plain "
              f"{out[name]['plain_ms']:.4f}, library {out[name]['library_ms']:.4f}, bound {bound_ms:.4f} by "
              f"{bound_by} with 3xTF32 products, {bound_f32_ms:.4f} in float32 FMA)", flush=True)
    return out


def _traced_chain_us(fn, reps: int = 20) -> dict:
    """Device time (us) of one call of ``fn``, a tiled kernel's chain of
    launches, from a ``torch.profiler`` trace of ``reps`` calls: the sum over
    its launches, and the share of the products (``product_kernel``), K1's
    one-pass blur (``blur_kernel``) and the band passes (the rest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {"product": 0.0, "blur": 0.0, "band": 0.0}
    n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "tiled::" in e.name:
            part = "product" if "product_kernel" in e.name else "blur" if "blur_kernel" in e.name else "band"
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


def _ms_per_step(run, warm: int = 3, iters: int = 10) -> float:
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
    bfloat16 (``--compute_dtype``), in one run; every row names its dtype."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        out.update(_step_times(dtype))
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
    variant_step_times(base, x, y, gen, sched, record)
    out.update(large_step_times(base, sched, record))
    return out


def large_step_times(base, sched, record) -> dict:
    """Phase 7 above 32 px, full metrics, in ``base``'s compute dtype: the
    imagenet10 alternated step (224 px, bs 32) on the K1/K2 route (the tiled
    kernels) and the ATen route, with the peak device memory of the K1/K2
    step; the imagenet10 victim step on K1; the celeba alternated step (64
    px, bs 128) on K1/K2.  224 px steps take ~1 s, so 2 warm-up and 5 timed
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
            ms = _ms_per_step(lambda: step(stateC, stateG, cm, nf, (x, y), gen), warm=2, iters=5)
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
                                                                   warm=2, iters=5), n)
            del C_, G, stateC, vstep
    return {f"{base.compute_dtype}/imagenet10/memory": memory}


def variant_step_times(cfg, x, y, gen, sched, record) -> None:
    """Phase 7, the variants: each variant's train step at full width (bs
    128, full metrics) on the K1/K2 route, and the WaNet victim step, in
    ``cfg``'s compute dtype."""
    import torch

    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.train import TrainState, freeze
    from combat_tpu_torch.train import variants

    x2 = torch.rand(x.shape, generator=gen, device=x.device) * 2 - 1
    poisoned = torch.rand((x.shape[0],), generator=gen, device=x.device) < 0.05
    for variant, kind in (("wanet", "grid"), ("inputaware", "unet"), ("imperceptible", "unet"),
                          ("multilabel", "cunet")):
        torch.manual_seed(4)
        C_, G = get_classifier(cfg).to(x.device), get_generator(cfg, kind).to(x.device)
        cm, nf = freeze(get_classifier(cfg).to(x.device)), freeze(get_frequency_detector(cfg).to(x.device))
        stateC, stateG = TrainState(C_, sched), TrainState(G, sched)
        step = getattr(variants, f"make_{variant}_train_step")(cfg, C_, G)
        batch = (x, y, x2) if variant == "inputaware" else (x, y)
        record(f"variant/{variant}", _ms_per_step(lambda: step(stateC, stateG, cm, nf, batch, gen)))
    torch.manual_seed(4)
    C_, G = get_classifier(cfg).to(x.device), freeze(get_generator(cfg, "grid").to(x.device))
    stateC = TrainState(C_, sched)
    vstep = variants.make_wanet_victim_train_step(cfg, C_, G)
    record("variant/victim wanet", _ms_per_step(lambda: vstep(stateC, (x, y, poisoned), gen)))


def _no_grad(fn, *args, **kw):
    import torch

    with torch.no_grad():
        return fn(*args, **kw)


def _to(obj, dev):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
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
    """Phases 5l-5q (``LARGE_PHASES``) or 5r-5t (``BF16_PHASES``): each
    entry point with the launch counts set to 0 just before it, held to its
    predicted counts just after; its checkpoint finite, with float32 models,
    its metrics percentages; a generator on the committed detector of its
    dataset where the repo holds one.  The save gates are open
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
            if entry == "train_generator" and dataset != "imagenet10" and payload["F_detector_loaded"] is not True:
                raise SystemExit(f"phase {phase} ran without the committed {dataset} frequency detector")
        if counts[phase] != dict(zip(KERNEL_NAMES, predicted)):
            raise SystemExit(f"phase {phase} launched {counts[phase]}, predicted {dict(zip(KERNEL_NAMES, predicted))}")
        print(f"  {phase}: {values}", flush=True)
        _phase(f"{phase} ({entry})", t0)
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.parse_args(argv)
    faulthandler.dump_traceback_later(900, exit=True)
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
    launches = {k: n + sum(per_phase[ph][k] for ph in expect)
                + sum(c[k] for c in (*variant_launches.values(), *large_launches.values(), *bf16_launches.values()))
                for k, n in launches.items()}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise SystemExit(f"kernels never launched on the main path: {missing}")

    # 6. the card's step against the CPU's
    t0 = time.perf_counter()
    step_agreement()
    variant_step_agreement()
    large_step_agreement()
    bf16_step_agreement()
    _phase("6 card vs CPU step", t0)

    # 7. the steady-state step
    t0 = time.perf_counter()
    print(json.dumps({"step": step_times()}), flush=True)
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
