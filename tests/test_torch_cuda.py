"""The port's CUDA kernels against their plain versions, on the card.

The machine with the card has no JAX, so this file imports only torch and
the port, and runs there without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Elsewhere its tests skip.  Tolerance 1e-4 absolute: float32 FMA in another
summation order than cuBLAS, on values of order 1 to 10.  K1/K2 are held at
32 and 64 px, 3 and 5 taps, a small and a large sigma (B^T != B), and a
full and a ragged plane count; K3 at 28-64 px and the cutoffs c = 1,
0.65 H and H.  Above 64 px the tiled kernels are held the same way at 65,
100 and 224 px (imagenet10: bs 32, 96 planes) and at 257 and 300 px, where
the products read the projector's depth in windows, and one alternated step at
96 px runs them inside the step, card against CPU.  Two checks of the tiled
design: K3 at 224 px within 2e-5 of its plain version, which three TF32
passes meet and one (~1e-3) does not; and K1's one-pass blur against the
dense B clip(u) B^T on K1's own u, within 1e-5 (a k-tap sum of values in
[-1, 1]; the low-pass's rounding does not enter).
"""

import pytest
import torch

from combat_tpu_torch.ops import trigger_kernels as tk
from combat_tpu_torch.ops.blur import blur_matrix, gaussian_kernel_1d

H, RATIO, NOISE_RATE = 32, 0.65, 0.08


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: python -m pytest --noconftest -m cuda tests/test_torch_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, n=128, h=H):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((n, 3, h, h), generator=gen, device=dev) * 2 - 1
    noise = torch.rand((n, 3, h, h), generator=gen, device=dev) * 2 - 1
    g = torch.randn((n, 3, h, h), generator=gen, device=dev)
    return x, noise, g


def _planes(dev, planes, h):
    """(x, noise, g) as (planes, 1, h, h) batches; 383 is a ragged count."""
    return tuple(t.reshape(-1, 1, h, h)[:planes].contiguous() for t in _inputs(dev, n=128, h=h))


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [384, 383])
@pytest.mark.parametrize("sigma", [0.14, 0.9])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("h", [32, 64])
def test_fused_trigger_kernels_match_plain(dev, h, k, sigma, planes):
    x, noise, g = _planes(dev, planes, h)
    taps = gaussian_kernel_1d(k, sigma, device=dev)
    B = blur_matrix(taps, h)
    D, M = tk.trigger_operands(h, RATIO, str(dev))
    Dc = tk.truncated_dct(h, RATIO, str(dev))
    before = dict(tk.LAUNCHES)
    out, u = tk.fused_trigger_fwd(x, noise, taps, Dc, NOISE_RATE)
    gx, gn = tk.fused_trigger_bwd(g, u, taps, Dc, NOISE_RATE)
    torch.cuda.synchronize()
    ref_out, ref_u = tk.fused_trigger_fwd_plain(x, noise, B, D, M, NOISE_RATE)
    # K2 on K1's own u: where u lies within rounding of +-1, the clamp mask of
    # the plain u can differ and flip that element's whole gradient.
    ref_gx, ref_gn = tk.fused_trigger_bwd_plain(g, u, B, D, M, NOISE_RATE)
    for got, ref in ((out, ref_out), (u, ref_u), (gx, ref_gx), (gn, ref_gn)):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    assert tk.LAUNCHES["fused_trigger_fwd"] == before["fused_trigger_fwd"] + 1
    assert tk.LAUNCHES["fused_trigger_bwd"] == before["fused_trigger_bwd"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize(
    "h,ratio,k",
    [(30, 0.65, 5), (48, 0.65, 5), (32, 0.01, 3), (32, 1.0, 3), (64, 1.0, 5), (32, 0.65, 63)],
    ids=["H30", "H48", "c0", "c=H", "c=H-64", "k63"],
)
def test_fused_trigger_kernels_other_sizes_cutoffs_and_blurs(dev, h, ratio, k):
    """The runtime-H kernels (H not 32 or 64, H % 4 != 0 at 30), the cutoff
    edges c = 0 and c = H, and the widest blur the wrappers take."""
    x, noise, g = _planes(dev, 383, h)
    taps = gaussian_kernel_1d(k, 0.9 if k < 10 else 9.0, device=dev)
    B = blur_matrix(taps, h)
    D, M = tk.trigger_operands(h, ratio, str(dev))
    out, u = tk.fused_trigger_fwd(x, noise, taps, tk.truncated_dct(h, ratio, str(dev)), NOISE_RATE)
    gx, gn = tk.fused_trigger_bwd(g, u, taps, tk.truncated_dct(h, ratio, str(dev)), NOISE_RATE)
    ref_out, ref_u = tk.fused_trigger_fwd_plain(x, noise, B, D, M, NOISE_RATE)
    ref_gx, ref_gn = tk.fused_trigger_bwd_plain(g, u, B, D, M, NOISE_RATE)
    for got, ref in ((out, ref_out), (u, ref_u), (gx, ref_gx), (gn, ref_gn)):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("k,sigma", [(3, 0.9), (5, 0.9)])
def test_fused_trigger_autograd_matches_the_plain_chain(dev, k, sigma):
    """FusedTrigger (K1 forward, K2 backward) against autograd through the
    plain dense chain, on the same inputs and cotangent."""
    x, noise, g = _inputs(dev, n=16)
    taps = gaussian_kernel_1d(k, sigma, device=dev)
    D, M = tk.trigger_operands(H, RATIO, str(dev))
    grads = []
    for fused in (True, False):
        xt, nt = x.clone().requires_grad_(), noise.clone().requires_grad_()
        if fused:
            out = tk.FusedTrigger.apply(xt, nt, taps, tk.truncated_dct(H, RATIO, str(dev)), NOISE_RATE)
        else:
            out, _ = tk.fused_trigger_fwd_plain(xt, nt, blur_matrix(taps, H), D, M, NOISE_RATE)
        grads.append((out, *torch.autograd.grad(out, (xt, nt), grad_outputs=g)))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "h,ratio",
    [(32, RATIO), (32, 1.5 / 32), (32, 1.0), (64, RATIO), (64, 1.5 / 64), (64, 1.0), (28, RATIO), (30, RATIO),
     (48, RATIO)],
    ids=["c20", "c1", "c=H", "H64-c41", "H64-c1", "H64-c=H", "H28", "H30", "H48"],
)
def test_low_freq_kernel_and_autograd_match_plain(dev, h, ratio):
    """K3 (P x P) against its plain version, the JAX kernel's dense D, M
    form: forward, and through autograd (K3 on the cotangent) against
    autograd through the plain chain; the runtime-H kernels at 28, 30, 48."""
    from combat_tpu_torch.ops.dct import low_freq

    x, _, g = _planes(dev, 383, h)
    D, M = tk.trigger_operands(h, ratio, str(dev))
    xt, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    before = tk.LAUNCHES["low_freq"]
    out = low_freq(xt, h, ratio, use_kernel=True)
    (gx,) = torch.autograd.grad(out, xt, grad_outputs=g)
    assert tk.LAUNCHES["low_freq"] == before + 2
    ref = tk.low_freq_plain(xp, D, M)
    (ref_gx,) = torch.autograd.grad(ref, xp, grad_outputs=g)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(gx, ref_gx, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_aten_route_runs_any_size_without_kernels(dev):
    """``--pallas_lowfreq false`` at 128 px, above the kernels' reach: the
    ATen chain against the plain dense form, and no kernel launched."""
    from combat_tpu_torch.ops.dct import low_freq

    x = torch.rand((4, 3, 128, 128), generator=torch.Generator(device=dev).manual_seed(1), device=dev) * 2 - 1
    D, M = tk.trigger_operands(128, RATIO, str(dev))
    before = dict(tk.LAUNCHES)
    out = low_freq(x, 128, RATIO, use_kernel=False)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == before
    torch.testing.assert_close(out, tk.low_freq_plain(x, D, M), atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("h,planes,ratio", [(65, 383, RATIO), (100, 383, RATIO), (224, 96, RATIO), (100, 7, 0.01),
                                            (72, 7, 1.0), (257, 96, RATIO), (300, 95, RATIO)],
                         ids=["H65", "H100", "H224", "H100-c0", "H72-c=H", "H257", "H300"])
def test_tiled_fused_trigger_kernels_match_plain(dev, h, planes, ratio, k):
    """K1/K2 above 64 px (the tiled chain: products with P, band passes)
    against the plain versions: H not a multiple of the 64-wide tile (65,
    100), imagenet10's 224 at bs 32, the cutoff edges c = 0 and c = H, and
    H above 224, where the products read P's depth in windows of 224 (257,
    300); one launch counted a call."""
    x, noise, g = _planes(dev, planes, h)
    taps = gaussian_kernel_1d(k, 0.9, device=dev)
    B = blur_matrix(taps, h)
    D, M = tk.trigger_operands(h, ratio, str(dev))
    Dc = tk.truncated_dct(h, ratio, str(dev))
    before = dict(tk.LAUNCHES)
    out, u = tk.fused_trigger_fwd(x, noise, taps, Dc, NOISE_RATE)
    gx, gn = tk.fused_trigger_bwd(g, u, taps, Dc, NOISE_RATE)
    torch.cuda.synchronize()
    assert {n: tk.LAUNCHES[n] - before[n] for n in before} == {"fused_trigger_fwd": 1, "fused_trigger_bwd": 1,
                                                               "low_freq": 0}
    ref_out, ref_u = tk.fused_trigger_fwd_plain(x, noise, B, D, M, NOISE_RATE)
    ref_gx, ref_gn = tk.fused_trigger_bwd_plain(g, u, B, D, M, NOISE_RATE)
    for got, ref in ((out, ref_out), (u, ref_u), (gx, ref_gx), (gn, ref_gn)):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("h,planes,ratio", [(65, 383, RATIO), (100, 383, 1.5 / 100), (224, 96, RATIO),
                                            (224, 96, 1.0), (257, 96, RATIO), (300, 95, 1.0)],
                         ids=["H65", "H100-c1", "H224", "H224-c=H", "H257", "H300-c=H"])
def test_tiled_low_freq_kernel_and_autograd_match_plain(dev, h, planes, ratio):
    """K3 above 64 px, forward and through autograd (the tiled K3 on the
    cotangent), against the plain dense chain; two launches.  Above 224 px
    the products read P's depth in windows (257, 300)."""
    from combat_tpu_torch.ops.dct import low_freq

    x, _, g = _planes(dev, planes, h)
    D, M = tk.trigger_operands(h, ratio, str(dev))
    xt, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    before = tk.LAUNCHES["low_freq"]
    out = low_freq(xt, h, ratio, use_kernel=True)
    (gx,) = torch.autograd.grad(out, xt, grad_outputs=g)
    assert tk.LAUNCHES["low_freq"] == before + 2
    ref = tk.low_freq_plain(xp, D, M)
    (ref_gx,) = torch.autograd.grad(ref, xp, grad_outputs=g)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(gx, ref_gx, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", [RATIO, 1.0], ids=["c145", "c=H"])
def test_tiled_low_freq_at_224_is_within_2e5_of_plain(dev, ratio):
    """The tensor-core products keep float32 accuracy: one TF32 pass errs
    ~1e-3 here, three passes ~3e-6."""
    x, _, _ = _planes(dev, 96, 224)
    D, M = tk.trigger_operands(224, ratio, str(dev))
    out = tk.low_freq_planes(x, ratio)
    torch.testing.assert_close(out, tk.low_freq_plain(x, D, M), atol=2e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("h,planes", [(65, 383), (100, 383), (224, 95)], ids=["H65", "H100", "H224"])
def test_tiled_blur_matches_the_dense_blur(dev, h, planes, k):
    """K1's one-pass blur (halo tiles through shared memory) against the
    dense B clip(u) B^T on K1's own u: sigma 0.9, where B^T != B at the
    reflect borders; ragged plane counts; H not a multiple of the 32-wide
    tile (65, 100)."""
    x, noise, _ = _planes(dev, planes, h)
    taps = gaussian_kernel_1d(k, 0.9, device=dev)
    B = blur_matrix(taps, h)
    out, u = tk.fused_trigger_fwd(x, noise, taps, tk.truncated_dct(h, RATIO, str(dev)), NOISE_RATE)
    torch.testing.assert_close(out, B @ u.clamp(-1.0, 1.0) @ B.T, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_fused_trigger_autograd_at_224_matches_the_plain_chain(dev):
    """FusedTrigger at imagenet10's 224 px (tiled K1 forward, K2 backward)
    against autograd through the plain dense chain."""
    x, noise, g = (t[:4].contiguous() for t in _inputs(dev, n=8, h=224))
    taps = gaussian_kernel_1d(3, 0.9, device=dev)
    D, M = tk.trigger_operands(224, RATIO, str(dev))
    grads = []
    for fused in (True, False):
        xt, nt = x.clone().requires_grad_(), noise.clone().requires_grad_()
        if fused:
            out = tk.FusedTrigger.apply(xt, nt, taps, tk.truncated_dct(224, RATIO, str(dev)), NOISE_RATE)
        else:
            out, _ = tk.fused_trigger_fwd_plain(xt, nt, blur_matrix(taps, 224), D, M, NOISE_RATE)
        grads.append((out, *torch.autograd.grad(out, (xt, nt), grad_outputs=g)))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_alternated_step_at_96px_on_the_card_matches_the_cpu(dev, monkeypatch):
    """One alternated step at 96 px (ResNet18, UNet nf 64, bs 4) on the card,
    where the tiled K1/K2 run inside the step, against the same step on the
    CPU (the plain versions), from the same weights and draws: losses and
    C's and G's updated parameters within 1e-4; K1 twice, K2 once."""
    import copy

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.train import TrainState, draw_alternated, freeze, make_alternated_train_step, multistep_lr

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = apply_dataset_preset(Config(dataset="celeba")).replace(input_height=96, input_width=96, bs=4)
    torch.manual_seed(0)
    weights = [get_classifier(cfg), get_generator(cfg), get_classifier(cfg), get_frequency_detector(cfg)]
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((4, 3, 96, 96), generator=gen) * 2 - 1
    y = torch.tensor([0, 0, 1, 2])
    draws = draw_alternated(cfg, 4, gen, "cpu")
    out = {}
    for d in (dev, torch.device("cpu")):
        C, G, cm, nf = (copy.deepcopy(m).to(d) for m in weights)
        sched = multistep_lr(0.01, (100,), 0.1, 10)
        stateC, stateG = TrainState(C, sched), TrainState(G, sched)
        before = dict(tk.LAUNCHES)
        moved = type(draws)(*(_to(v, d) for v in draws))
        m = make_alternated_train_step(cfg, C, G)(stateC, stateG, freeze(cm), freeze(nf), (x.to(d), y.to(d)),
                                                  draws=moved)
        out[d.type] = (m, C.state_dict(), G.state_dict(), {k: tk.LAUNCHES[k] - n for k, n in before.items()})
    assert out["cuda"][3] == {"fused_trigger_fwd": 2, "fused_trigger_bwd": 1, "low_freq": 0}
    assert not any(out["cpu"][3].values())
    for k in ("loss_ce", "loss_l2", "clean_model_loss"):
        torch.testing.assert_close(out["cuda"][0][k].cpu(), out["cpu"][0][k], atol=1e-4, rtol=1e-4,
                                   msg=lambda m, k=k: f"{k}: {m}")
    for i in (1, 2):
        for k, v in out["cpu"][i].items():
            if v.is_floating_point():
                torch.testing.assert_close(out["cuda"][i][k].cpu(), v, atol=1e-4, rtol=0,
                                           msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.cuda
def test_victim_step_launches_k1_not_k2_and_matches_the_plain_route(dev):
    """G is frozen in the victim step, so the fused route launches K1 once
    and never K2; from the same weights and draws it agrees with the ATen
    route (no kernel) within 1e-4: the loss, and C's updated parameters."""
    import copy

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_generator
    from combat_tpu_torch.train import TrainState, draw_victim, freeze, make_victim_train_step, multistep_lr

    base = apply_dataset_preset(Config())
    torch.manual_seed(0)
    C0, G = get_classifier(base).to(dev), freeze(get_generator(base).to(dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((16, 3, H, H), generator=gen, device=dev) * 2 - 1
    y = torch.arange(16, device=dev) % 4
    poisoned = torch.arange(16, device=dev) % 3 == 0
    draws = draw_victim(base, 16, gen, dev)
    out = {}
    for route, fused in (("k1", True), ("plain", False)):
        C = copy.deepcopy(C0)
        state = TrainState(C, multistep_lr(0.01, (100,), 0.1, 10))
        before = dict(tk.LAUNCHES)
        m = make_victim_train_step(base.replace(pallas_trigger=fused), C, G)(state, (x, y, poisoned), draws=draws)
        torch.cuda.synchronize()
        out[route] = (m["loss_ce"], C.state_dict(), {k: tk.LAUNCHES[k] - n for k, n in before.items()})
    assert out["k1"][2] == {"fused_trigger_fwd": 1, "fused_trigger_bwd": 0, "low_freq": 0}
    assert not any(out["plain"][2].values())
    torch.testing.assert_close(out["k1"][0], out["plain"][0], atol=1e-4, rtol=0)
    for k, v in out["plain"][1].items():
        if v.is_floating_point():
            torch.testing.assert_close(out["k1"][1][k], v, atol=1e-4, rtol=0, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "variant,launches",
    [("inputaware", {"fused_trigger_fwd": 3, "fused_trigger_bwd": 2, "low_freq": 0}),
     ("multilabel", {"fused_trigger_fwd": 2, "fused_trigger_bwd": 1, "low_freq": 0})],
)
def test_variant_step_on_the_card_matches_the_cpu(dev, monkeypatch, variant, launches):
    """One full-width input-aware or multilabel step on the card (K1/K2)
    against the same step on the CPU (the plain versions), from the same
    weights and draws: the losses, and C's and G's updated parameters,
    within 1e-4.  Input-aware triggers three times a step and backpropagates
    two of them; multilabel triggers twice and backpropagates one.  cuDNN's
    TF32 is off, as the entry points set it, so the convolutions are float32."""
    import copy

    from combat_tpu_torch.config import Config, apply_dataset_preset
    from combat_tpu_torch.models import get_classifier, get_frequency_detector, get_generator
    from combat_tpu_torch.train import TrainState, draw_alternated, draw_inputaware, freeze, multistep_lr
    from combat_tpu_torch.train import variants

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = apply_dataset_preset(Config())
    torch.manual_seed(0)
    kind = "cunet" if variant == "multilabel" else "unet"
    weights = [get_classifier(cfg), get_generator(cfg, kind), get_classifier(cfg), get_frequency_detector(cfg)]
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((16, 3, H, H), generator=gen) * 2 - 1
    x2 = torch.rand((16, 3, H, H), generator=gen) * 2 - 1
    y = torch.arange(16) % 4
    draws = (draw_inputaware if variant == "inputaware" else draw_alternated)(cfg, 16, gen, "cpu")
    batch = (x, y, x2) if variant == "inputaware" else (x, y)
    make = getattr(variants, f"make_{variant}_train_step")
    out = {}
    for d in (dev, torch.device("cpu")):
        C, G, cm, nf = (copy.deepcopy(m).to(d) for m in weights)
        sched = multistep_lr(0.01, (100,), 0.1, 10)
        stateC, stateG = TrainState(C, sched), TrainState(G, sched)
        before = dict(tk.LAUNCHES)
        moved = type(draws)(*(_to(v, d) for v in draws))
        m = make(cfg, C, G)(stateC, stateG, freeze(cm), freeze(nf), tuple(t.to(d) for t in batch), draws=moved)
        out[d.type] = (m, C.state_dict(), G.state_dict(), {k: tk.LAUNCHES[k] - n for k, n in before.items()})
    assert out["cuda"][3] == launches and not any(out["cpu"][3].values())
    for k in ("loss_ce", "loss_l2", "clean_model_loss"):
        torch.testing.assert_close(out["cuda"][0][k].cpu(), out["cpu"][0][k], atol=1e-4, rtol=1e-4,
                                   msg=lambda m, k=k: f"{k}: {m}")
    for i in (1, 2):
        for k, v in out["cpu"][i].items():
            if v.is_floating_point():
                torch.testing.assert_close(out["cuda"][i][k].cpu(), v, atol=1e-4, rtol=0,
                                           msg=lambda m, k=k: f"{k}: {m}")


def _to(obj, d):
    if isinstance(obj, torch.Tensor):
        return obj.to(d)
    return type(obj)(*(_to(v, d) for v in obj))
