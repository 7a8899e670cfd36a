"""The port's trigger kernels K1-K3 (combat_tpu_torch/ops/trigger_kernels.py)
against the JAX package's Pallas kernels.

On the CPU the wrappers run their kernels' plain versions, so these tests
hold the plain versions, forward and backward, to ``fused_trigger_pallas``
and ``low_freq_pallas`` run in Pallas interpret mode.  Tolerance 5e-5
absolute, as tests/test_pallas.py holds the Pallas kernels to the XLA chain:
the values are O(1) and pass through four to six float32 32x32 products.

K1 and K2 take the blur's taps and D_c, the first c rows of the DCT matrix;
their plain versions keep the JAX kernels' dense (D, M, B) form, which the
CPU wrappers build from the taps and D_c.  The kernels themselves are
compared with the plain versions on the card by tests/test_torch_cuda.py and
by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import nchw, nhwc
from combat_tpu_torch.ops import trigger_kernels as tk
from combat_tpu_torch.ops.blur import blur_matrix, gaussian_kernel_1d
from combat_tpu_torch.ops.dct import low_freq

ATOL = 5e-5
H, RATIO, NOISE_RATE = 32, 0.65, 0.08


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("COMBAT_PALLAS_INTERPRET", "1")
    torch.set_num_threads(1)


def _inputs(seed, n=2, h=H):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, h, h, 3)).astype(np.float32)
    noise = rng.uniform(-1, 1, (n, h, h, 3)).astype(np.float32)
    g = rng.standard_normal((n, h, h, 3)).astype(np.float32)
    return x, noise, g


def _blur(sigma, h=H, k=3):
    from combat_tpu.ops.blur import gaussian_kernel_1d as jax_kernel
    from combat_tpu.ops.pallas_kernels import _blur_matrix

    B_jax = _blur_matrix(jax_kernel(k, jnp.float32(sigma)), h)
    B = blur_matrix(gaussian_kernel_1d(k, sigma), h)
    return B_jax, B


@pytest.mark.parametrize("sigma", [0.14, 0.9])
def test_blur_matrix_matches_jax(sigma):
    B_jax, B = _blur(sigma)
    np.testing.assert_allclose(B.numpy(), np.asarray(B_jax), atol=1e-7)
    # reflect padding makes B asymmetric at the boundary rows: the adjoint
    # must use B^T (tests/test_pallas.py:81-99)
    assert not np.array_equal(B.numpy(), B.numpy().T)


# sigma 0.9 is the large-sigma adjoint case of tests/test_pallas.py:81-99:
# at small sigma B is near-identity and B^T g B cannot be told from B g B^T.
# k = 5 reflects two rows at each border.
@pytest.mark.parametrize(
    "k,sigma",
    [pytest.param(3, 0.14, id="0.14"), pytest.param(3, 0.9, id="0.9"),
     pytest.param(5, 0.14, id="k5-0.14"), pytest.param(5, 0.9, id="k5-0.9")],
)
def test_fused_trigger_k1_k2_plain_match_pallas(k, sigma):
    from combat_tpu.ops.pallas_kernels import fused_trigger_pallas

    x, noise, g = _inputs(0)
    B_jax, _ = _blur(sigma, k=k)
    out_jax, vjp = jax.vjp(lambda a, b: fused_trigger_pallas(a, b, B_jax, H, RATIO, NOISE_RATE), x, noise)
    gx_jax, gn_jax = vjp(jnp.asarray(g))

    xt, nt = nchw(x).requires_grad_(), nchw(noise).requires_grad_()
    taps, Dc = gaussian_kernel_1d(k, sigma), tk.truncated_dct(H, RATIO, "cpu")
    out = tk.FusedTrigger.apply(xt, nt, taps, Dc, NOISE_RATE)
    gx, gn = torch.autograd.grad(out, (xt, nt), grad_outputs=nchw(g))

    np.testing.assert_allclose(nhwc(out), np.asarray(out_jax), atol=ATOL)
    np.testing.assert_allclose(nhwc(gx), np.asarray(gx_jax), atol=ATOL)
    np.testing.assert_allclose(nhwc(gn), np.asarray(gn_jax), atol=ATOL)


def test_fused_trigger_saves_preclip_injection():
    """K1's second output u is the pre-clip injection the JAX kernel saves."""
    x, noise, _ = _inputs(1)
    taps, Dc = gaussian_kernel_1d(3, 0.5), tk.truncated_dct(H, RATIO, "cpu")
    _, u = tk.fused_trigger_fwd(nchw(x), nchw(noise), taps, Dc, NOISE_RATE)
    expected = nchw(x) + low_freq(nchw(noise), H, RATIO) * NOISE_RATE
    np.testing.assert_allclose(u.numpy(), expected.numpy(), atol=ATOL)


def test_low_freq_k3_plain_matches_pallas_fwd_and_vjp():
    from combat_tpu.ops.pallas_kernels import low_freq_pallas

    x, _, g = _inputs(2, n=3)
    out_jax, vjp = jax.vjp(lambda a: low_freq_pallas(a, H, RATIO), x)
    (gx_jax,) = vjp(jnp.asarray(g))

    xt = nchw(x).requires_grad_()
    out = low_freq(xt, H, RATIO)
    (gx,) = torch.autograd.grad(out, xt, grad_outputs=nchw(g))
    np.testing.assert_allclose(nhwc(out), np.asarray(out_jax), atol=ATOL)
    np.testing.assert_allclose(nhwc(gx), np.asarray(gx_jax), atol=ATOL)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    x, noise, g = _inputs(3)
    taps = gaussian_kernel_1d(3, 0.5)
    B = blur_matrix(taps, H)
    D, M = tk.trigger_operands(H, RATIO, "cpu")
    Dc = tk.truncated_dct(H, RATIO, "cpu")
    before = dict(tk.LAUNCHES)
    out, u = tk.fused_trigger_fwd(nchw(x), nchw(noise), taps, Dc, NOISE_RATE)
    ref_out, ref_u = tk.fused_trigger_fwd_plain(nchw(x), nchw(noise), B, D, M, NOISE_RATE)
    assert torch.equal(out, ref_out) and torch.equal(u, ref_u)
    gx, gn = tk.fused_trigger_bwd(nchw(g), u, taps, Dc, NOISE_RATE)
    assert torch.equal(gn, tk.fused_trigger_bwd_plain(nchw(g), u, B, D, M, NOISE_RATE)[1])
    assert torch.equal(tk.low_freq_planes(nchw(x), D, M), tk.low_freq_plain(nchw(x), D, M))
    assert tk.LAUNCHES == before


def test_wrappers_refuse_mixed_devices_and_large_planes():
    D, M = tk.trigger_operands(H, RATIO, "cpu")
    with pytest.raises(ValueError, match="one device"):
        tk.low_freq_planes(torch.zeros(1, 3, H, H, device="meta"), D, M)
    big = torch.zeros(1, 3, 128, 128)
    D128, M128 = tk.trigger_operands(128, RATIO, "cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        tk._check_cuda(big, D128, M128)
    with pytest.raises(ValueError, match="contiguous float32"):
        tk._check_cuda(big.double()[..., :64, :64], D, M)


@pytest.mark.parametrize("h", [32, 64])
@pytest.mark.parametrize("ratio", [0.65, 0.3, 1.0, 0.01])
def test_truncated_dct_is_the_masked_lowpass(h, ratio):
    """D_c is the first int(h*ratio) rows of the port's D (and of the JAX
    package's), and D_c^T (D_c y D_c^T) D_c is the masked low-pass, also at
    the edges c = h (ratio 1) and c = 0 (ratio 0.01)."""
    from combat_tpu.ops.dct import _dct_matrix_np as jax_dct
    from combat_tpu.ops.pallas_kernels import _trigger_operands

    c = int(h * ratio)
    D, M = tk.trigger_operands(h, ratio, "cpu")
    Dc = tk.truncated_dct(h, ratio, "cpu")
    assert tuple(Dc.shape) == (c, h) and Dc.is_contiguous()
    assert torch.equal(Dc, D[:c])
    d_jax, m_jax = _trigger_operands(jnp.zeros((1, h, h, 3)), h, ratio)
    np.testing.assert_allclose(Dc.numpy(), jax_dct(h)[:c], atol=1e-7)
    np.testing.assert_array_equal(M.numpy(), np.asarray(m_jax))
    np.testing.assert_array_equal(D.numpy(), np.asarray(d_jax))
    y = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (3, h, h)).astype(np.float32))
    truncated = Dc.T @ (Dc @ y @ Dc.T) @ Dc
    np.testing.assert_allclose(truncated.numpy(), tk._lowpass_plain(y, D, M).numpy(), atol=1e-5)


@pytest.mark.parametrize("k,sigma", [(3, 0.9), (3, 0.14), (5, 0.9), (5, 0.14)])
def test_cpu_wrappers_build_the_blur_from_the_taps(k, sigma):
    """Taps in: the CPU wrappers give what the plain versions give with
    B = blur_matrix(taps), the form of the earlier (B, D, M) call."""
    x, noise, g = _inputs(5)
    taps = gaussian_kernel_1d(k, sigma)
    B = blur_matrix(taps, H)
    D, M = tk.trigger_operands(H, RATIO, "cpu")
    Dc = tk.truncated_dct(H, RATIO, "cpu")
    out, u = tk.fused_trigger_fwd(nchw(x), nchw(noise), taps, Dc, NOISE_RATE)
    ref_out, ref_u = tk.fused_trigger_fwd_plain(nchw(x), nchw(noise), B, D, M, NOISE_RATE)
    assert torch.equal(out, ref_out) and torch.equal(u, ref_u)
    gx, gn = tk.fused_trigger_bwd(nchw(g), u, taps, Dc, NOISE_RATE)
    ref_gx, ref_gn = tk.fused_trigger_bwd_plain(nchw(g), u, B, D, M, NOISE_RATE)
    assert torch.equal(gx, ref_gx) and torch.equal(gn, ref_gn)


def test_fused_trigger_wrappers_validate_their_operands():
    x, noise, g = (nchw(a) for a in _inputs(6))
    Dc = tk.truncated_dct(H, RATIO, "cpu")
    with pytest.raises(ValueError, match="kernel_size // 2 < H"):
        tk.fused_trigger_fwd(x, noise, torch.ones(2 * H + 1) / (2 * H + 1), Dc, NOISE_RATE)
    with pytest.raises(ValueError, match="kernel_size // 2 < H"):
        tk.fused_trigger_bwd(g, x, torch.ones(2 * H) / (2 * H), Dc, NOISE_RATE)
    with pytest.raises(ValueError, match="one device"):
        tk.fused_trigger_fwd(x, noise, gaussian_kernel_1d(3, 0.5, device="meta"), Dc, NOISE_RATE)
    with pytest.raises(ValueError, match="D_c of shape"):
        tk.fused_trigger_fwd(x, noise, gaussian_kernel_1d(3, 0.5), Dc.T.contiguous(), NOISE_RATE)
    # the largest blur the wrappers take: k // 2 = H - 1, as blur_matrix allows
    taps = gaussian_kernel_1d(2 * H - 1, 9.0)
    out, _ = tk.fused_trigger_fwd(x, noise, taps, Dc, NOISE_RATE)
    assert torch.isfinite(out).all()


def test_fused_trigger_at_cutoff_zero_is_the_plain_result():
    """ratio 0.01 keeps no coefficient at 32px: low is -1 everywhere and g_n
    is 0, as the Pallas kernels give (no raise)."""
    x, noise, g = (nchw(a) for a in _inputs(7))
    taps = gaussian_kernel_1d(3, 0.9)
    Dc = tk.truncated_dct(H, 0.01, "cpu")
    assert tuple(Dc.shape) == (0, H)
    out, u = tk.fused_trigger_fwd(x, noise, taps, Dc, NOISE_RATE)
    gx, gn = tk.fused_trigger_bwd(g, u, taps, Dc, NOISE_RATE)
    B = blur_matrix(taps, H)
    D, M = tk.trigger_operands(H, 0.01, "cpu")
    ref_out, ref_u = tk.fused_trigger_fwd_plain(x, noise, B, D, M, NOISE_RATE)
    torch.testing.assert_close(u, x - NOISE_RATE, atol=1e-6, rtol=0)
    assert torch.equal(out, ref_out) and torch.equal(u, ref_u)
    assert torch.equal(gn, torch.zeros_like(gn))
    assert torch.equal(gx, tk.fused_trigger_bwd_plain(g, u, B, D, M, NOISE_RATE)[0])
