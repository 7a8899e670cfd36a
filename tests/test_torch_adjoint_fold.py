"""The decomposition of the tiled K2's adjoint blur, and K2's plain g_u
against the JAX package's kernel.

``csrc/trigger_tiled.cuh::adjoint_kernel`` computes B^T g B for planes above
64 px in one pass: a block owns a 56 x 32 output tile, the taps come in
chunks of 8, and along each axis B^T folds three windows of the
zero-padded source onto the outputs (the direct one, and at the plane's
edges the near and far mirrored ones), each staged without reflected
indices.  A CUDA kernel cannot run here, so :func:`adjoint_tiled` replays
that decomposition in float64 with numpy (tiles, halo, chunks, sides, the
guards q > 0 and q < H - 1, and the sides a tile skips) and is held to the
dense B^T s B.  The kernel itself is held to the dense adjoint on the card
by ``tests/test_torch_cuda.py``.

The second test holds the port's plain K2 (``fused_trigger_bwd_plain``,
what the wrappers run on the CPU and what the card's kernel is compared
with) to ``_fused_trigger_bwd_kernel`` of the JAX package, through
``fused_trigger_pallas``'s VJP in Pallas interpret mode, at sizes that take
the tiled path on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
from numpy.lib.stride_tricks import sliding_window_view
import pytest
import torch

from _torch_helpers import nchw, nhwc
from combat_tpu_torch.ops import trigger_kernels as tk
from combat_tpu_torch.ops.blur import blur_matrix, gaussian_kernel_1d

TILE_ROWS, TILE_COLS, CHUNK = 56, 32, 8  # adjoint_kernel's output tile and tap chunk
DIRECT, NEAR, FAR = 0, 1, 2


def _first(side, q0, t0, nt, p, h):
    """Source index of staged position 0 of a side (trigger_tiled.cuh::side_first)."""
    return (q0 + p - t0 - nt + 1, p - t0 - q0, 2 * (h - 1) + p - t0 - q0)[side]


def _position(side, first, w):
    return first + w if side == DIRECT else first - w


NONE, PASS, FOLD = 0, 1, 2


def _work(side, first, direct_first, count, h):
    """trigger_tiled.cuh::side_work, per tile: no source in the plane, a pass
    of its own, or (a mirrored side whose sources in the plane lie in the
    direct window) reads of the direct pass's buffer."""
    lo = np.maximum(first if side == DIRECT else first - (count - 1), 0)
    hi = np.minimum(first + count - 1 if side == DIRECT else first, h - 1)
    fold = (side != DIRECT) & (lo >= direct_first) & (hi < direct_first + count)
    return np.where(lo > hi, NONE, np.where(fold, FOLD, PASS))


def _takes(side, q, h, guards=True):
    if side == DIRECT or not guards:
        return np.ones_like(q, dtype=bool)
    return q > 0 if side == NEAR else q < h - 1


def _taps(taps, t0, nt, side):
    """The taps a side applies at the offsets of its window: the direct side's reversed."""
    chunk = taps[t0:t0 + nt]
    return chunk[::-1] if side == DIRECT else chunk


def _mirrored_read(buf, idx, valid, axis):
    """buf's entries at idx along axis where valid, else 0 (a fold's read)."""
    shape = list(buf.shape)
    shape[axis] = idx.shape[axis]
    at = np.broadcast_to(np.clip(idx, 0, buf.shape[axis] - 1), shape)
    return np.take_along_axis(buf, at, axis=axis) * valid


def adjoint_tiled(s, taps, guards=True):
    """B^T s B for one H x H plane in float64, as adjoint_kernel decomposes it."""
    h, k = s.shape[0], len(taps)
    p = k // 2
    zero = np.zeros((h + 1, h + 1))  # index h reads 0: what the kernel stages outside the plane
    zero[:h, :h] = s
    i0 = np.arange(0, h, TILE_ROWS)[:, None, None, None]  # (tiles_i, 1, 1, 1)
    j0 = np.arange(0, h, TILE_COLS)[None, :, None, None]  # (1, tiles_j, 1, 1)
    rows_out = np.minimum(TILE_ROWS, h - i0)
    ii, lane = np.arange(TILE_ROWS)[:, None], np.arange(TILE_COLS)[None, :]
    acc = np.zeros((i0.shape[0], j0.shape[1], TILE_ROWS, TILE_COLS))
    for t0 in range(0, k, CHUNK):
        nt = min(CHUNK, k - t0)
        staged = rows_out + nt - 1
        w_row = np.arange(TILE_ROWS + nt - 1)[:, None]  # staged rows
        rd = _first(DIRECT, i0, t0, nt, p, h)
        for si in (DIRECT, NEAR, FAR):
            ri = _first(si, i0, t0, nt, p, h)
            row_pass = _work(si, ri, rd, staged, h) == PASS
            if not row_pass.any():
                continue
            rows = _position(si, ri, w_row)
            rows = np.where((w_row < staged) & (rows >= 0) & (rows < h), rows, h)
            R = np.zeros((i0.shape[0], j0.shape[1], TILE_ROWS + nt - 1, TILE_COLS))
            for c0 in range(0, k, CHUNK):
                nc = min(CHUNK, k - c0)
                width = TILE_COLS + nc - 1
                w_col = np.arange(width)[None, :]
                cd = _first(DIRECT, j0, c0, nc, p, h)
                for sj in (DIRECT, NEAR, FAR):
                    cj = _first(sj, j0, c0, nc, p, h)
                    col_pass = _work(sj, cj, cd, width, h) == PASS
                    if not col_pass.any():
                        continue
                    cols = _position(sj, cj, w_col)
                    cols = np.where((cols >= 0) & (cols < h), cols, h)
                    shape = np.broadcast_shapes(rows.shape, cols.shape)
                    S = zero[np.broadcast_to(rows, shape), np.broadcast_to(cols, shape)]
                    takes = _takes(sj, j0 + lane, h, guards)
                    R += col_pass * takes * (sliding_window_view(S, nc, axis=3) @ _taps(taps, c0, nc, sj))
                    if sj != DIRECT:
                        continue
                    for mj in (NEAR, FAR):  # the mirrored sides read backwards from this window
                        first = _first(mj, j0, c0, nc, p, h)
                        fold = col_pass & (_work(mj, first, cd, width, h) == FOLD)
                        if not fold.any():
                            continue
                        for c in range(nc):
                            idx = first - cd - lane - c
                            valid = fold & _takes(mj, j0 + lane, h, guards) & (idx >= 0) & (idx < width)
                            R += taps[c0 + c] * _mirrored_read(S, idx, valid, axis=3)
            takes = row_pass * _takes(si, i0 + ii, h, guards)
            rows_win = sliding_window_view(R, nt, axis=2)  # (tiles_i, tiles_j, TILE_ROWS, TILE_COLS, nt)
            acc += takes * (rows_win @ _taps(taps, t0, nt, si))
            if si != DIRECT:
                continue
            for mi in (NEAR, FAR):  # the mirrored sides read backwards from R
                first = _first(mi, i0, t0, nt, p, h)
                fold = row_pass & (_work(mi, first, rd, staged, h) == FOLD)
                if not fold.any():
                    continue
                for t in range(nt):
                    idx = first - rd - ii - t
                    valid = fold & _takes(mi, i0 + ii, h, guards) & (idx >= 0) & (idx < staged)
                    acc += taps[t0 + t] * _mirrored_read(R, idx, valid, axis=2)
    out = acc.transpose(0, 2, 1, 3).reshape(i0.shape[0] * TILE_ROWS, j0.shape[1] * TILE_COLS)
    return out[:h, :h]


@pytest.mark.parametrize("h,k", [(h, k) for h in (65, 100, 224, 257) for k in (3, 5, 9, 17, 199) if k // 2 < h])
def test_the_tiled_fold_is_the_dense_adjoint(h, k):
    """Tiles, halo, 8-tap chunks and the three-term fold equal B^T s B in
    float64: H not a multiple of 56 or 32 (65, 100, 257), taps past one
    chunk (9, 17) and a halo wider than a tile (199; every k with
    k // 2 < H, as the kernels take)."""
    s = np.random.default_rng(h * 1000 + k).standard_normal((h, h))
    B = blur_matrix(gaussian_kernel_1d(k, 0.9, dtype=torch.float64), h).numpy()
    taps = gaussian_kernel_1d(k, 0.9, dtype=torch.float64).numpy()
    np.testing.assert_allclose(adjoint_tiled(s, taps), B.T @ s @ B, atol=1e-12, rtol=0)


def test_the_fold_needs_its_guards():
    """Without [q > 0] and [q < H - 1] the outputs at q = 0 and H - 1 count
    their own term twice: the check above would fail."""
    h, k = 65, 3
    s = np.random.default_rng(0).standard_normal((h, h))
    taps = gaussian_kernel_1d(k, 0.9, dtype=torch.float64).numpy()
    B = blur_matrix(torch.from_numpy(taps), h).numpy()
    assert np.abs(adjoint_tiled(s, taps, guards=False) - B.T @ s @ B).max() > 1e-2


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("h", [65, 100])
def test_plain_k2_gu_matches_the_jax_kernel(monkeypatch, h, k):
    """4 planes (2 images x 2 channels), sigma 0.9 (B^T != B at the
    borders): the port's plain g_u against the JAX kernel's g_x, within
    5e-5."""
    from combat_tpu.ops.blur import gaussian_kernel_1d as jax_kernel
    from combat_tpu.ops.pallas_kernels import _blur_matrix, fused_trigger_pallas

    monkeypatch.setenv("COMBAT_PALLAS_INTERPRET", "1")
    ratio, noise_rate = 0.65, 0.08
    rng = np.random.default_rng(h + k)
    x = rng.uniform(-1, 1, (2, h, h, 2)).astype(np.float32)
    noise = rng.uniform(-1, 1, (2, h, h, 2)).astype(np.float32)
    g = rng.standard_normal((2, h, h, 2)).astype(np.float32)
    B_jax = _blur_matrix(jax_kernel(k, jnp.float32(0.9)), h)
    _, vjp = jax.vjp(lambda a, b: fused_trigger_pallas(a, b, B_jax, h, ratio, noise_rate), x, noise)
    gx_jax, _ = vjp(jnp.asarray(g))

    taps, Dc = gaussian_kernel_1d(k, 0.9), tk.truncated_dct(h, ratio, "cpu")
    _, u = tk.fused_trigger_fwd(nchw(x), nchw(noise), taps, Dc, noise_rate)
    D, M = tk.trigger_operands(h, ratio, "cpu")
    gu, _ = tk.fused_trigger_bwd_plain(nchw(g), u, blur_matrix(taps, h), D, M, noise_rate)
    assert ((u < -1) | (u > 1)).any()  # the mask cuts somewhere
    np.testing.assert_allclose(nhwc(gu), np.asarray(gx_jax), atol=5e-5)
