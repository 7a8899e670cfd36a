#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``combat_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printing one line with its seconds:
  1. the card's name and power limit (nvidia-smi), then one ``nvcc`` build
     of the trigger kernels K1-K3 (``combat_tpu_torch/csrc/trigger.cu``);
  2. each kernel, forward and backward, held to its plain PyTorch version
     (K1/K2 at 32 and 64 px, 3 and 5 taps, two sigmas, 384 and 383 planes;
     K3 at the slice's shapes, bs 128, 3 x 32 x 32 f32), and timed with CUDA
     events at the slice's shapes beside its plain version and the same
     function as dense ``torch.matmul``s (``library_ms``); K1/K2 also at
     64 px, and their device durations traced with ``torch.profiler``;
  3. ``train_clean_classifier`` at full width (PreActResNet18, bs 128,
     1024 synthetic images: 8 steps, then eval);
  4. ``train_generator`` on that checkpoint, fused trigger (K1/K2): 8
     alternated steps with UNet nf=64, then the attack eval;
  5. ``train_generator --pallas_trigger false`` (K3): 2 alternated steps;
  6. one alternated step at full width on the card against the same step on
     the CPU, from the same weights and draws;
  7. the steady-state alternated step at full width (bs 128), timed on the
     host clock around synchronised runs of 10 steps, in both trigger
     configurations and both metric modes.
Then one JSON line of the kernels (launches on the main path, phases 3-5,
errors, times, bounds) and, last, ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when torch sees no CUDA device or the
package is missing; any failed check or phase raises.  A hang ends after
900 s as a traceback and a non-zero exit.
"""

from __future__ import annotations

import argparse
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
KERNEL_TOL = 1e-4  # float32 FMA in another order than cuBLAS; values O(1)
BS, C, H = 128, 3, 32
RATIO, NOISE_RATE = 0.65, 0.08


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


def _bound_ms(nbytes: int, flops: int):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _err(a, b) -> float:
    return float((a - b).abs().max())


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
    out, u = tk.fused_trigger_fwd(x, noise, taps, Dc, NOISE_RATE)
    low = tk.low_freq_planes(x, D, M)
    ref_out, ref_u = tk.fused_trigger_fwd_plain(x, noise, B, D, M, NOISE_RATE)
    ref_gx, ref_gn = tk.fused_trigger_bwd_plain(g, ref_u, B, D, M, NOISE_RATE)
    ref_low = tk.low_freq_plain(x, D, M)
    ref_low_bwd = tk.low_freq_plain(g, D, M)
    low_bwd = tk.low_freq_planes(g.contiguous(), D, M)  # K3's backward: the same kernel on the cotangent
    lib_out, lib_u = lib_fwd()
    lib_gx, lib_gn = lib_bwd(lib_u)
    torch.cuda.synchronize()

    errors["low_freq"] = max(_err(low, ref_low), _err(low_bwd, ref_low_bwd))
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
            _event_ms(lambda: tk.low_freq_planes(x, D, M)),
            _event_ms(lambda: tk.low_freq_plain(x, D, M)),
            _event_ms(lambda: torch.matmul(flat(x), L_t)),
        ),
    }
    time_trigger_variants(taps, Dc)
    # Bytes: each input read once, each output written once; K1/K2 read D_c
    # and the taps once per call, K3 D and M.  Operations: the least the
    # function needs per plane (one FMA = 2).  The low-pass keeps only the
    # c x c corner of the coefficients, so its four products shrink to
    # 2c*H*H + 2c*c*H FMAs; its affine pre- and post-scaling folds away (the
    # DC passes the mask).  The blur B c B^T (and B^T g B) is banded: one
    # pass per side of `taps` FMAs per output.  Elementwise: u = x + r*low
    # and the clamp (4) forward; the clamp mask (3) backward.
    c = Dc.shape[0]
    lowpass = 2 * (2 * c * H * H + 2 * c * c * H)
    blur = 2 * (2 * H * H * taps.numel())
    trigger_bytes = 4 * plane_bytes + Dc.numel() * 4 + taps.numel() * 4
    work = {
        "fused_trigger_fwd": (trigger_bytes, (lowpass + blur + 4 * H * H) * planes),
        "fused_trigger_bwd": (trigger_bytes, (lowpass + blur + 3 * H * H) * planes),
        "low_freq": (2 * plane_bytes + 2 * mat_bytes, lowpass * planes),
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
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        }
        print(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f}, dense matmuls {library_ms:.4f}, "
              f"bound {bound_ms:.4f} by {bound_by})", flush=True)
    return rows


def time_trigger_variants(taps, Dc) -> None:
    """K1/K2 at 64 px (384 planes, c = 41) beside their plain versions, then
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
    print(f"  H=64: fused_trigger_fwd {fwd[0]:.4f} ms (plain {fwd[1]:.4f}); "
          f"fused_trigger_bwd {bwd[0]:.4f} ms (plain {bwd[1]:.4f})", flush=True)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for h, planes, dc in ((H, sms, Dc), (H, BS * C, Dc), (64, BS * C, Dc64)):
        x, noise, g = (t[:planes] for t in _trigger_inputs(h, seed=8))
        u = tk.fused_trigger_fwd(x, noise, taps, dc, NOISE_RATE)[1]
        traced = _traced_us({
            "fused_trigger_fwd_kernel": lambda: tk.fused_trigger_fwd(x, noise, taps, dc, NOISE_RATE),
            "fused_trigger_bwd_kernel": lambda: tk.fused_trigger_bwd(g, u, taps, dc, NOISE_RATE),
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


def check_checkpoint(path: str) -> None:
    """Every tensor a run saved is finite."""
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


def step_agreement() -> None:
    """Phase 6: one full-width alternated step on the card (kernels) and on
    the CPU (plain versions) from the same weights and draws.  Losses agree
    to 1e-3 relative and updated parameters to 1e-4 absolute (an update at
    lr 0.01 is ~1e-3; cuDNN and the CPU sum in other orders)."""
    import torch

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.train import TrainState, draw_alternated, freeze, make_alternated_train_step, multistep_lr

    cfg = apply_dataset_preset(Config())
    torch.manual_seed(1)
    weights = [get_classifier(cfg), get_generator(cfg), get_classifier(cfg), get_frequency_detector(cfg)]
    gen = torch.Generator().manual_seed(2)
    x = torch.rand((16, 3, 32, 32), generator=gen) * 2 - 1
    y = torch.arange(16) % 4  # a quarter target-class rows
    draws = draw_alternated(cfg, 16, gen, "cpu")
    results = {}
    for dev in ("cuda", "cpu"):
        C, G, cm, nf = (copy.deepcopy(m).to(dev) for m in weights)
        sched = multistep_lr(0.01, (100,), 0.1, 10)
        stateC, stateG = TrainState(C, sched), TrainState(G, sched)
        step = make_alternated_train_step(cfg, C, G)
        d = _to(draws, dev)
        m = step(stateC, stateG, freeze(cm), freeze(nf), (x.to(dev), y.to(dev)), draws=d)
        results[dev] = ({k: float(v) for k, v in m.items()}, C.state_dict(), G.state_dict())
    (m_gpu, c_gpu, g_gpu), (m_cpu, c_cpu, g_cpu) = results["cuda"], results["cpu"]
    for k in ("loss_ce", "loss_l2", "clean_model_loss", "loss_grad_l2"):
        if not abs(m_gpu[k] - m_cpu[k]) <= 1e-3 * max(1.0, abs(m_cpu[k])):
            raise SystemExit(f"card and CPU disagree on {k}: {m_gpu[k]} vs {m_cpu[k]}")
    worst = max(
        float((a[k].cpu().float() - b[k].float()).abs().max())
        for a, b in ((c_gpu, c_cpu), (g_gpu, g_cpu))
        for k in b
        if b[k].is_floating_point()
    )
    print(f"  card vs CPU, one step: losses {m_gpu['loss_ce']:.6f} vs {m_cpu['loss_ce']:.6f}; "
          f"max |param diff| = {worst:.3e} (tolerance 1e-4)", flush=True)
    if not worst <= 1e-4:
        raise SystemExit(f"card and CPU parameters disagree after one step: {worst}")


def step_times() -> dict:
    """Phase 7: ms per alternated step at full width, bs 128, after 3
    warm-up steps (cuDNN picks its algorithms there), over 10 steps."""
    import torch

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.train import TrainState, freeze, make_alternated_train_step, multistep_lr

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((BS, C, H, H), generator=gen, device=dev) * 2 - 1
    y = torch.randint(0, 10, (BS,), generator=gen, device=dev)
    out = {}
    for fused in (True, False):
        for mode in ("full", "loss_only"):
            cfg = apply_dataset_preset(Config()).replace(pallas_trigger=fused, train_metrics=mode)
            torch.manual_seed(4)
            C_, G = get_classifier(cfg).to(dev), get_generator(cfg).to(dev)
            cm, nf = freeze(get_classifier(cfg).to(dev)), freeze(get_frequency_detector(cfg).to(dev))
            sched = multistep_lr(0.01, (100,), 0.1, 10)
            stateC, stateG = TrainState(C_, sched), TrainState(G, sched)
            step = make_alternated_train_step(cfg, C_, G)
            for _ in range(3):
                step(stateC, stateG, cm, nf, (x, y), gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                m = step(stateC, stateG, cm, nf, (x, y), gen)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / 10
            if not bool(torch.isfinite(m["loss_ce"])):
                raise SystemExit("non-finite loss in the steady-state steps")
            key = f"{'pallas_trigger' if fused else 'lowfreq_blur'}/{mode}"
            out[key] = {"ms_per_step": ms, "images_per_s": BS * 1e3 / ms}
            print(f"  alternated step, {key}: {ms:.3f} ms ({BS * 1e3 / ms:.0f} img/s)", flush=True)
    return out


def _to(obj, dev):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    return type(obj)(*(_to(v, dev) for v in obj))


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
    from combat_tpu_torch.cli import train_clean_classifier, train_generator
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
        check_checkpoint(f"{workdir}/smoke_atk_clean/cifar10/cifar10_smoke_atk_clean.pt")
        per_phase["4"] = dict(tk.LAUNCHES)
        _phase("4 train_generator (pallas_trigger)", t0)

        # 5. the same step with the low-pass kernel K3 + clamp + blur: 2 steps + eval
        t0 = time.perf_counter()
        best_k3 = train_generator.main(common + ["--synthetic_size", "256", "--saving_prefix", "smoke_k3",
                                                 "--load_checkpoint_clean", "smoke_clean",
                                                 "--pallas_trigger", "false"])
        check_checkpoint(f"{workdir}/smoke_k3_clean/cifar10/cifar10_smoke_k3_clean.pt")
        launches = dict(tk.LAUNCHES)  # read right after the main path
        per_phase["5"] = launches
        _phase("5 train_generator (pallas_trigger false)", t0)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for metrics in (best, best_k3):
        if not all(v == v and abs(v) < float("inf") for v in metrics.values()):
            raise SystemExit(f"non-finite eval metrics: {metrics}")
    print(f"  launches after phases 3, 4, 5: {json.dumps(per_phase)}", flush=True)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise SystemExit(f"kernels never launched on the main path: {missing}")

    # 6. the card's step against the CPU's
    t0 = time.perf_counter()
    step_agreement()
    _phase("6 card vs CPU step", t0)

    # 7. the steady-state step
    t0 = time.perf_counter()
    print(json.dumps({"step": step_times()}), flush=True)
    _phase("7 steady-state alternated step", t0)

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
