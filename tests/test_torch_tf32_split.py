"""The numerical design of the tiled products, on the CPU.

Above 64 px the trigger kernels compute P X P (and K1's and K2's low-pass
halves) on the tensor cores in three TF32 passes: each operand split into
big = tf32(v) and small = tf32(v - big), then small.big + big.small +
big.big summed in float32 (``csrc/trigger_tiled.cuh``).  The kernels run
only on the card; here ``trigger_kernels.tf32_product`` emulates their
arithmetic, rounding by bit masks as ``cvt.rna.tf32.f32`` does, and these
tests hold the design's claims:

* three passes of P X P at 224 px on 96 planes (imagenet10, bs 32) are
  within 1e-5 of float64 (found 2.2e-6, float32's own 1.9e-6), and one
  pass misses the port's 1e-4 tolerance (found 1.1e-3);
* the emulated three-pass K3 chain, W = (X P)^T then (W P)^T, agrees with
  the JAX package's ``low_freq_pallas`` at 224 px in interpret mode within
  2e-5, the tolerance of ``tests/test_torch_large_images.py``, in value and
  through its VJP (the same chain on the cotangent);
* ``lowpass_projector`` is exactly symmetric, on which the transposed-store
  formulation P Z = (Z^T P)^T rests;
* the split projector the wrapper hands the kernels holds P's big and small
  parts in the order the kernels' B fragments read them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import nchw, nhwc
from combat_tpu_torch.ops import trigger_kernels as tk

RATIO = 0.65
TRIGGER_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("COMBAT_PALLAS_INTERPRET", "1")
    torch.set_num_threads(1)


def _planes(seed, planes, h):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, (planes, h, h)).astype(np.float32))


@pytest.mark.parametrize(
    "value,rounded",
    [(1 + 2**-11, 1 + 2**-10), (-(1 + 2**-11), -(1 + 2**-10)), (1 + 3 * 2**-11, 1 + 2**-9), (1 + 2**-12, 1.0),
     (1 + 2**-11 + 2**-20, 1 + 2**-10), (0.1, 0.0999755859375)],
    ids=["tie-up", "tie-negative", "tie-odd", "below-half", "above-half", "0.1"],
)
def test_tf32_round_is_to_nearest_with_ties_away_from_zero(value, rounded):
    got = tk.tf32_round(torch.tensor([value], dtype=torch.float32))
    assert got.item() == rounded
    assert tk.tf32_round(got).item() == rounded  # a TF32 value is its own rounding


def test_tf32_split_keeps_about_21_bits():
    """big + small recovers v to 2^-21 of |v|; big alone only to 2^-11."""
    v = _planes(0, 4, 64).reshape(-1) * 300.0
    big = tk.tf32_round(v)
    small = tk.tf32_round(v - big)
    assert float(((big - v).abs() / v.abs()).max()) <= 2**-11
    assert float(((big.double() + small.double() - v.double()).abs() / v.double().abs()).max()) <= 2**-21


@pytest.mark.parametrize("h,planes", [(224, 96), (100, 8), (65, 8)], ids=["H224-96planes", "H100", "H65"])
def test_three_pass_lowpass_is_within_1e5_of_float64(h, planes):
    x = _planes(1, planes, h)
    P = tk.lowpass_projector(h, RATIO, "cpu")
    ref = P.double() @ x.double() @ P.double()
    err = float((tk.low_freq_tf32(x, P).double() - ref).abs().max())
    print(f"three TF32 passes of P X P at {h} px, {planes} planes: {err:.2e} from float64")
    assert err <= 1e-5


def test_one_pass_lowpass_at_224_misses_the_tolerance():
    """The reason the kernels never run a single TF32 pass."""
    x = _planes(1, 96, 224)
    P = tk.lowpass_projector(224, RATIO, "cpu")
    ref = P.double() @ x.double() @ P.double()
    err = float((tk.low_freq_tf32(x, P, passes=1).double() - ref).abs().max())
    print(f"one TF32 pass of P X P at 224 px, 96 planes: {err:.2e} from float64")
    assert err > 1e-4


def test_emulated_three_pass_k3_at_224_matches_pallas_fwd_and_vjp():
    from combat_tpu.ops.pallas_kernels import low_freq_pallas

    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 224, 224, 3)).astype(np.float32)
    g = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    out_jax, vjp = jax.vjp(lambda a: low_freq_pallas(a, 224, RATIO), x)
    (gx_jax,) = vjp(jnp.asarray(g))
    P = tk.lowpass_projector(224, RATIO, "cpu")
    out, gx = tk.low_freq_tf32(nchw(x), P), tk.low_freq_tf32(nchw(g), P)
    print("emulated three-pass K3 at 224 px against Pallas: value, VJP",
          *(f"{np.abs(nhwc(a) - np.asarray(b)).max():.2e}" for a, b in ((out, out_jax), (gx, gx_jax))))
    np.testing.assert_allclose(nhwc(out), np.asarray(out_jax), atol=TRIGGER_ATOL)
    np.testing.assert_allclose(nhwc(gx), np.asarray(gx_jax), atol=TRIGGER_ATOL)


@pytest.mark.parametrize("ratio", [RATIO, 1.0], ids=["c=0.65H", "c=H"])
@pytest.mark.parametrize("h", [65, 100, 224])
def test_lowpass_projector_is_exactly_symmetric(h, ratio):
    P = tk.lowpass_projector(h, ratio, "cpu")
    assert torch.equal(P, P.T)
    x = _planes(3, 2, h).double()
    Pd = P.double()
    # the transposed-store chain: ((X P)^T P)^T = P X P, exactly so in float64 up to rounding
    torch.testing.assert_close(((x @ Pd).transpose(-1, -2) @ Pd).transpose(-1, -2), Pd @ x @ Pd, atol=1e-12, rtol=0)


@pytest.mark.parametrize("h", [65, 100, 224])
def test_split_projector_is_in_fragment_order(h):
    """Row n of the tiled products' P operand: for each 8-deep block kb of k,
    big(8 kb + t), big(8 kb + t + 4) for t = 0..3, then the small parts the
    same way; the depth padded with zeros to a multiple of 8."""
    ps = tk._projector_split(h, int(h * RATIO), "cpu")
    P = tk.lowpass_projector(h, RATIO, "cpu")
    kp = -(-h // 8) * 8
    assert tuple(ps.shape) == (h, 2 * kp)
    big = tk.tf32_round(P)
    small = tk.tf32_round(P - big)
    k = torch.arange(h)
    slot = (k // 8) * 16 + 2 * (k % 4) + (k % 8) // 4
    assert torch.equal(ps[:, slot], big)
    assert torch.equal(ps[:, slot + 8], small)
    rest = torch.ones(2 * kp, dtype=torch.bool)
    rest[slot] = rest[slot + 8] = False
    assert not ps[:, rest].any()  # the padding past H
