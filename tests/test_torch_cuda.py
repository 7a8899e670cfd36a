"""The port's CUDA kernels against their plain versions, on the card.

The machine with the card has no JAX, so this file imports only torch and
the port, and runs there without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Elsewhere its tests skip.  Tolerance 1e-4 absolute: float32 FMA in another
summation order than cuBLAS, on values of order 1 to 10.  K1/K2 are held at
32 and 64 px, 3 and 5 taps, a small and a large sigma (B^T != B), and a
full and a ragged plane count.
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
def test_low_freq_kernel_and_autograd_match_plain(dev):
    from combat_tpu_torch.ops.dct import low_freq

    x, _, g = _inputs(dev, n=8)
    xt = x.clone().requires_grad_()
    out = low_freq(xt, H, RATIO)
    (gx,) = torch.autograd.grad(out, xt, grad_outputs=g)
    D, M = tk.trigger_operands(H, RATIO, str(dev))
    torch.testing.assert_close(out, tk.low_freq_plain(x, D, M), atol=1e-4, rtol=0)
    torch.testing.assert_close(gx, tk.low_freq_plain(g, D, M), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_wrappers_raise_for_planes_above_64(dev):
    D, M = tk.trigger_operands(128, RATIO, str(dev))
    with pytest.raises(NotImplementedError, match="later slice"):
        tk.low_freq_planes(torch.zeros(1, 3, 128, 128, device=dev), D, M)
