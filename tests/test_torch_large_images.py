"""Large images in the port: the uint8 residency of large splits, the row
chunking of the augmentation's resample, and the trigger kernels' functions
at imagenet10's 224 px, each against the JAX package.

* Splits above 1 GiB of float32 live on the device as uint8 in both
  packages (``cli/common.py``), and every gathered batch is dequantized as
  ``u8 / 127.5 - 1`` (``train/loop.py``).  The thresholds are monkeypatched
  to a few KB here, so a small synthetic split takes that route; the stored
  bytes and the gathered float32 batches are held bit-exact.
* Above ``_CHUNK_BYTES`` the resample runs over blocks of output rows; with
  the budget monkeypatched small at 32 px, chunked and single-shot agree
  within 1e-5 in value and in the gradient in x (the same terms summed per
  row block), and both agree with JAX within 2e-5, the tolerance of
  tests/test_torch_ops.py for the augmentation (the port is 1.2e-5 from
  JAX in value and 1.8e-5 in the gradient here, the test prints them:
  float32 coordinates and contractions in another order).
* The trigger at 224 px on the CPU route (the kernels' plain versions)
  against ``fused_trigger_pallas`` and ``low_freq_pallas`` in Pallas
  interpret mode: the low-pass sums 224-term products of values up to 255
  before the 2/255 scale.  Found (the tests print them, ``pytest -s``):
  3.8e-6 for K3's value and VJP, 2.4e-7 for K1's and K2's outputs (the
  fused chain low-passes the noise, scaled by 0.08); held to 2e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import jax_aug_draws, nchw, nhwc
from combat_tpu_torch.ops import trigger_kernels as tk
from combat_tpu_torch.ops.blur import gaussian_kernel_1d
from combat_tpu_torch.ops.dct import low_freq

TRIGGER_ATOL = 2e-5
H224, RATIO, NOISE_RATE = 224, 0.65, 0.08


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("COMBAT_PALLAS_INTERPRET", "1")
    torch.set_num_threads(1)


# --------------------------------------------------------------------------
# uint8 residency (F5)
# --------------------------------------------------------------------------


def _configs(size=16):
    from combat_tpu.config import Config as JaxConfig
    from combat_tpu.config import apply_dataset_preset as jax_preset

    from combat_tpu_torch.config import Config, apply_dataset_preset

    kw = dict(dataset="celeba", synthetic_data=True, synthetic_size=size)
    return jax_preset(JaxConfig(**kw)), apply_dataset_preset(Config(device="cpu", **kw))


def _both_splits(monkeypatch, threshold, train=True):
    """(JAX images and labels as numpy, the port's images and labels) with
    both packages' residency thresholds set to ``threshold`` bytes."""
    from combat_tpu.cli import common as jax_common
    from combat_tpu.train.mesh import make_mesh

    from combat_tpu_torch.cli import common

    monkeypatch.setattr(jax_common, "_U8_RESIDENCY_BYTES", threshold)
    monkeypatch.setattr(common, "_U8_RESIDENCY_BYTES", threshold)
    jcfg, cfg = _configs()
    jimages, jlabels, _ = jax_common.device_dataset(jcfg, make_mesh(1), train)
    images, labels = common.device_dataset(cfg, torch.device("cpu"), train)
    return jimages, np.asarray(jlabels), images, labels


@pytest.mark.parametrize("train", [True, False])
def test_large_split_is_resident_as_uint8_like_jax(monkeypatch, train):
    """Above the threshold the port's split is uint8 and bit-equal to the
    JAX package's (NCHW against NHWC); small quantization blocks (a few
    rows each) give the same bytes as one block."""
    from combat_tpu_torch.cli import common

    monkeypatch.setattr(common, "_QUANT_BLOCK_BYTES", 3 * 64 * 64 * 3 * 4)  # blocks of 3 rows
    jimages, jlabels, images, labels = _both_splits(monkeypatch, 4096, train)
    assert images.dtype == torch.uint8 and jimages.dtype == jnp.uint8
    np.testing.assert_array_equal(images.numpy().transpose(0, 2, 3, 1), np.asarray(jimages))
    np.testing.assert_array_equal(labels.numpy(), jlabels)
    assert images.shape[1:] == (3, 64, 64) and int(images.max()) > 200 and int(images.min()) < 50


def test_gathered_uint8_batches_equal_jax_gather_batch(monkeypatch):
    """``gather_batch`` on the uint8 split gives the JAX ``gather_batch``'s
    float32 batch bit for bit, and every epoch runner hands the step the
    dequantized batch."""
    from combat_tpu.train.loop import gather_batch as jax_gather

    from combat_tpu_torch.train import eval_epoch, gather_batch, train_epoch_classifier

    jimages, _, images, labels = _both_splits(monkeypatch, 4096)
    idx = np.array([5, 0, 15, 7, 7], np.int32)
    got = gather_batch(images, torch.from_numpy(idx).long())
    ref = np.asarray(jax_gather(jimages, jnp.asarray(idx)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(nhwc(got), ref)
    assert float(got.min()) >= -1.0 and float(got.max()) <= 1.0

    seen = []

    def step(batch):
        seen.append(batch[0])
        return {"n": torch.tensor(float(batch[0].shape[0]))}

    perm = torch.randperm(16, generator=torch.Generator().manual_seed(0))
    train_epoch_classifier(lambda state, batch, gen: step(batch), None, images, labels, None, 6, perm=perm)
    eval_epoch(step, (), images, labels, 6)
    assert all(b.dtype == torch.float32 for b in seen)
    train_rows = torch.cat(seen[:3])
    assert torch.equal(train_rows, gather_batch(images, perm))


def test_split_at_or_below_the_threshold_stays_float32(monkeypatch):
    """At exactly the threshold the split stays float32 in both packages, and
    the gather passes it through unchanged (cifar10's 614 MB split keeps its
    float32 numbers)."""
    from combat_tpu_torch.data import get_dataset
    from combat_tpu_torch.train import dequantize, gather_batch

    _, cfg = _configs()
    nbytes = get_dataset(cfg, True).images.nbytes
    jimages, _, images, _ = _both_splits(monkeypatch, nbytes)
    assert images.dtype == torch.float32 and jimages.dtype == jnp.float32
    np.testing.assert_array_equal(images.numpy().transpose(0, 2, 3, 1), np.asarray(jimages))
    idx = torch.tensor([3, 1])
    assert torch.equal(gather_batch(images, idx), images[idx]) and dequantize(images) is images


# --------------------------------------------------------------------------
# the augmentation's row chunking
# --------------------------------------------------------------------------


def test_chunked_augmentation_matches_single_shot_and_jax(monkeypatch):
    """A budget of 300 kB at 32 px, bs 4 (a 2.1 MB intermediate) gives 8
    blocks of 4 rows in both packages: values and the gradient in x of the
    chunked resample against the single shot and against JAX."""
    from combat_tpu.ops import augment as jax_augment

    from combat_tpu_torch.ops import augment

    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    g = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    key = jax.random.key(15)
    draws = jax_aug_draws(key, 4)
    assert bool(draws.rot_gate) and bool(draws.crop_gate)  # this key rotates and crops

    def port(budget):
        monkeypatch.setattr(augment, "_CHUNK_BYTES", budget)
        xt = nchw(x).requires_grad_()
        out = augment.post_tensor_transform(xt, draws)
        (gx,) = torch.autograd.grad(out, xt, grad_outputs=nchw(g))
        return nhwc(out), nhwc(gx)

    out1, gx1 = port(augment._CHUNK_BYTES)
    outc, gxc = port(300_000)
    monkeypatch.setattr(jax_augment, "_CHUNK_BYTES", 300_000)
    ref, vjp = jax.vjp(lambda a: jax_augment.post_tensor_transform(key, a), jnp.asarray(x))
    (ref_gx,) = vjp(jnp.asarray(g))
    print("chunked vs single shot, vs JAX (value, gradient):",
          *(f"{np.abs(a - b).max():.2e}" for a, b in ((outc, out1), (gxc, gx1), (outc, ref), (gxc, ref_gx))))
    np.testing.assert_allclose(outc, out1, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gxc, gx1, atol=1e-5, rtol=0)
    np.testing.assert_allclose(outc, np.asarray(ref), atol=2e-5, rtol=0)
    np.testing.assert_allclose(gxc, np.asarray(ref_gx), atol=2e-5, rtol=0)


def test_chunk_blocks_are_the_smallest_divisor_of_h(monkeypatch):
    """At 224 px and bs 32 the 4.5 GB intermediate runs as 28 blocks of 8
    rows (the JAX package's rule); 32 px at bs 128 stays one shot."""
    from combat_tpu_torch.ops import augment

    calls = []
    real = torch.einsum

    def einsum(eq, *ops):
        if eq == "bijx,bcyx->bcijy":
            calls.append(ops[0].shape[1])
            n, rows, w, s = ops[0].shape
            return torch.zeros(n, ops[1].shape[1], rows, w, s)  # the shapes only, not the 4.5 GB
        return real(eq, *ops)

    monkeypatch.setattr(augment.torch, "einsum", einsum)
    x = torch.zeros(32, 3, 224, 224)
    draws = augment.draw_augment(32, torch.Generator().manual_seed(0), "cpu", 5, 10.0)
    inter = 32 * 3 * 224 * 224 * 234 * 4
    assert inter > augment._CHUNK_BYTES and -(-inter // augment._CHUNK_BYTES) == 17
    out = augment.post_tensor_transform(x[:, :, :, :], draws)
    assert calls == [8] * 28 and out.shape == x.shape
    calls.clear()
    augment.post_tensor_transform(torch.zeros(128, 3, 32, 32), augment.draw_augment(128, None, "cpu", 5, 10.0))
    assert calls == [32]


# --------------------------------------------------------------------------
# the trigger at 224 px
# --------------------------------------------------------------------------


def _trigger_inputs(seed, n=2, h=H224):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, h, h, 3)).astype(np.float32)
    noise = rng.uniform(-1, 1, (n, h, h, 3)).astype(np.float32)
    g = rng.standard_normal((n, h, h, 3)).astype(np.float32)
    return x, noise, g


@pytest.mark.parametrize("sigma", [0.14, 0.9])
def test_fused_trigger_at_224_matches_pallas(sigma):
    """K1's and K2's functions (the CPU route: their plain versions) for two
    224 px images against the JAX fused Pallas trigger and its VJP."""
    from combat_tpu.ops.blur import gaussian_kernel_1d as jax_kernel
    from combat_tpu.ops.pallas_kernels import _blur_matrix, fused_trigger_pallas

    x, noise, g = _trigger_inputs(0)
    B_jax = _blur_matrix(jax_kernel(3, jnp.float32(sigma)), H224)
    out_jax, vjp = jax.vjp(lambda a, b: fused_trigger_pallas(a, b, B_jax, H224, RATIO, NOISE_RATE), x, noise)
    gx_jax, gn_jax = vjp(jnp.asarray(g))

    xt, nt = nchw(x).requires_grad_(), nchw(noise).requires_grad_()
    taps, Dc = gaussian_kernel_1d(3, sigma), tk.truncated_dct(H224, RATIO, "cpu")
    assert tuple(Dc.shape) == (145, H224)
    out = tk.FusedTrigger.apply(xt, nt, taps, Dc, NOISE_RATE)
    gx, gn = torch.autograd.grad(out, (xt, nt), grad_outputs=nchw(g))
    print(f"K1/K2 at 224 px, sigma {sigma}: |out|, |g_x|, |g_n| errors",
          *(f"{np.abs(nhwc(a) - np.asarray(b)).max():.2e}" for a, b in ((out, out_jax), (gx, gx_jax), (gn, gn_jax))))
    np.testing.assert_allclose(nhwc(out), np.asarray(out_jax), atol=TRIGGER_ATOL)
    np.testing.assert_allclose(nhwc(gx), np.asarray(gx_jax), atol=TRIGGER_ATOL)
    np.testing.assert_allclose(nhwc(gn), np.asarray(gn_jax), atol=TRIGGER_ATOL)


def test_low_freq_at_224_matches_pallas_fwd_and_vjp():
    """K3's function (the CPU route) and its VJP at 224 px against the JAX
    Pallas low-pass; P x P with the 224 px projector is that function."""
    from combat_tpu.ops.pallas_kernels import low_freq_pallas

    x, _, g = _trigger_inputs(1)
    out_jax, vjp = jax.vjp(lambda a: low_freq_pallas(a, H224, RATIO), x)
    (gx_jax,) = vjp(jnp.asarray(g))
    xt = nchw(x).requires_grad_()
    out = low_freq(xt, H224, RATIO, use_kernel=True)
    (gx,) = torch.autograd.grad(out, xt, grad_outputs=nchw(g))
    print("K3 at 224 px: value, VJP errors",
          *(f"{np.abs(nhwc(a) - np.asarray(b)).max():.2e}" for a, b in ((out, out_jax), (gx, gx_jax))))
    np.testing.assert_allclose(nhwc(out), np.asarray(out_jax), atol=TRIGGER_ATOL)
    np.testing.assert_allclose(nhwc(gx), np.asarray(gx_jax), atol=TRIGGER_ATOL)
    P = tk.lowpass_projector(H224, RATIO, "cpu")
    np.testing.assert_allclose(nhwc(P @ nchw(x) @ P), np.asarray(out_jax), atol=TRIGGER_ATOL)
