"""Hand-written CUDA kernels for the trigger chain, and their plain versions.

Three Pallas TPU kernels of ``combat_tpu/ops/pallas_kernels.py`` become
kernels in ``combat_tpu_torch/csrc/trigger.cu`` and ``trigger_tiled.cuh``
(sm_90a, plain ``extern "C"`` interface, loaded with ctypes):

  K1 ``fused_trigger_fwd`` replaces ``pallas_kernels.py:_fused_trigger_impl``
     (kernel ``_fused_trigger_fwd_kernel``).  Per (image, channel) plane:
     y = (n+1)*127.5; low = D_c^T (D_c y D_c^T) D_c * 2/255 - 1;
     u = x + noise_rate*low (saved); out = blur_k(clip(u, -1, 1)).
  K2 ``fused_trigger_bwd`` replaces ``pallas_kernels.py:_fused_trigger_vjp_bwd``
     (kernel ``_fused_trigger_bwd_kernel``): g_u = blur_k^T(g)*1{-1<=u<=1};
     g_x = g_u; g_n = noise_rate * D_c^T (D_c g_u D_c^T) D_c.
  K3 ``low_freq`` replaces ``pallas_kernels.py:_low_freq_pallas_impl``
     (kernel ``_low_freq_kernel``): D^T((D y D^T) o M)D * 2/255 - 1 with
     y = (x+1)*127.5, computed as P x P with the projector P = D_c^T D_c.
     Self-adjoint for a DC-passing mask, so the backward pass is the same
     kernel on the cotangent.

``D_c`` is the first ``c = int(H*ratio)`` rows of the orthonormal DCT-II
matrix D (:func:`truncated_dct`): the JAX kernels' mask M keeps the c x c
corner of the coefficients, so D^T((D y D^T) o M)D = D_c^T (D_c y D_c^T) D_c.
``blur_k`` is the reflect-padded k-tap blur B c B^T of ``ops/blur.py``; K1
and K2 take its taps and apply it as a band, never the dense B.

Bound on an H100 SXM at the slice's shapes (bs 128, 3 x 32 x 32 f32, so 384
planes): K1 and K2 read two 1.57 MB arrays and write two (6.3 MB, ~1.88 us
at 3.35 TB/s).  The least work they need is the truncated low-pass plus the
banded 3-tap blur, ~57 MFLOP (~0.9 us at 67 TFLOP/s of f32 FMA), so they are
bound by bytes; K3 moves 3.1 MB and needs ~50 MFLOP, bound by bytes at
~0.94 us.  The first design of K1/K2 (one block per plane, six dense H^3
products with both operands loaded from shared memory for every FMA) was
held back by shared-memory loads, ~12 k warp-wide loads per plane, and did
2.7x the work the function needs.  The current K1/K2 do only the truncated
products and the band, tile the products in registers so each loaded value
feeds several FMAs, and copy D_c and the plane's inputs into shared memory
with ``cp.async`` while the block sets up; one block per plane, as before.
On an H100 they run at ~22% of their bound, held back by the latency of each
block's dependent chain of products; ``trigger.cu`` has the details.  K3
shortens that chain: the low-pass equals P x P with P = D_c^T D_c
(:func:`lowpass_projector`), two register-tiled H^3 products with one
barrier between them in place of four products and three barriers, and the
affine scaling folds away (P passes the all-ones plane once c >= 1).  On an
H100 one block's chain takes 3.2 us (K1/K2: 5.5 us) and K3 runs at ~15% of
its bound at the slice's shapes.

Planes above 64 px (imagenet10's 224) take the tiled kernels of
``csrc/trigger_tiled.cuh``: one plane and its operator no longer fit one
block's shared memory, so each logical kernel is a chain of launches over
the batch, with one workspace tensor the wrapper allocates: batched
register-tiled products with the projector P (K3: X P, then P Z; K1 and K2
the same two with their epilogues) and band passes of the blur, one output
element a thread.  There they are bound by operations (2 H^3 FMA a plane
for the two products), not bytes.  Each wrapper call still counts one
launch in :data:`LAUNCHES`.

Beside each kernel: its plain PyTorch version, which keeps the JAX kernels'
dense (D, M, B) form, is the CPU path and what ``chip_smoke.py`` compares the
kernel with; a launch count in :data:`LAUNCHES`; and the
``torch.autograd.Function`` that wires it into training (:class:`FusedTrigger`,
:class:`LowFreq`).  A wrapper takes the plain version only for a CPU tensor.
For a CUDA tensor it launches the kernel or raises.

The library is built at first use by one ``nvcc`` call into
``build/combat_tpu_torch/`` of the checkout, named by the hash of the
sources and flags, written under a temporary name and ``os.replace``d into
place so concurrent processes cannot race.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from .blur import blur_matrix

PLANE_PER_BLOCK_MAX = 64  # up to here one block holds a plane; above, the tiled kernels
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCE = _CSRC / "trigger.cu"
_HEADERS = (_CSRC / "trigger_tiled.cuh",)  # included by trigger.cu
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "combat_tpu_torch"

# Launches per kernel; each wrapper adds one where it launches, nowhere else.
LAUNCHES: Dict[str, int] = {"fused_trigger_fwd": 0, "fused_trigger_bwd": 0, "low_freq": 0}

_lib = None
BUILD_LOG = ""  # nvcc's output (ptxas register / shared-memory report)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    tried = []
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        tried.append(path)
        if os.path.exists(path):
            return path
    found = shutil.which("nvcc")
    if found:
        return found
    tried.append("nvcc on PATH")
    raise RuntimeError(f"nvcc not found (tried {', '.join(tried)}); the trigger kernels need the CUDA toolkit")


def build() -> ctypes.CDLL:
    """Compile ``csrc/trigger.cu`` (if its hash changed) and load it."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    text = b"".join(p.read_bytes() for p in (_SOURCE, *_HEADERS))
    digest = hashlib.sha256(text + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libcombat_trigger_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{BUILD_LOG}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.combat_fused_trigger_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, f, p]
    lib.combat_fused_trigger_bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, f, p]
    lib.combat_low_freq.argtypes = [p, p, p, i, i, p]
    lib.combat_fused_trigger_fwd_tiled.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, p]
    lib.combat_fused_trigger_bwd_tiled.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, p]
    lib.combat_low_freq_tiled.argtypes = [p, p, p, p, i, i, p]
    for fn in (lib.combat_fused_trigger_fwd, lib.combat_fused_trigger_bwd, lib.combat_low_freq,
               lib.combat_fused_trigger_fwd_tiled, lib.combat_fused_trigger_bwd_tiled, lib.combat_low_freq_tiled):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


# --------------------------------------------------------------------------
# Operands
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dct_matrix_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix: D[k, i] = s_k * cos(pi*(2i+1)k / (2n))."""
    k = np.arange(n)[:, None].astype(np.float64)
    i = np.arange(n)[None, :].astype(np.float64)
    mat = np.cos(np.pi * (2.0 * i + 1.0) * k / (2.0 * n)) * np.sqrt(2.0 / n)
    mat[0] *= np.sqrt(0.5)
    return mat


@functools.lru_cache(maxsize=None)
def _dense_operands(h: int, cutoff: int, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    d = torch.tensor(_dct_matrix_np(h), dtype=torch.float32, device=device)
    idx = torch.arange(h, device=device)
    mask = ((idx < cutoff)[:, None] & (idx < cutoff)[None, :]).to(torch.float32)
    return d, mask


def trigger_operands(h: int, ratio: float, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(D, M): the (h, h) DCT-II matrix and the ``int(h*ratio)`` low-pass
    square mask, float32 on ``device``."""
    return _dense_operands(h, int(h * ratio), device)


@functools.lru_cache(maxsize=None)
def truncated_dct(h: int, ratio: float, device: str) -> torch.Tensor:
    """D_c: the first ``c = int(h*ratio)`` rows of the DCT-II matrix, the
    (c, h) float32 operand of K1/K2 (c may be 0)."""
    d, _ = trigger_operands(h, ratio, device)
    return d[: int(h * ratio)].contiguous()


def lowpass_projector(h: int, ratio: float, device: str) -> torch.Tensor:
    """P = D_c^T D_c, the (h, h) operand of K3 (and of K1/K2 above 64 px):
    the symmetric projector onto the first ``c = int(h*ratio)`` DCT basis
    vectors, so the low-pass of a plane y is P y P.  Built in float64,
    stored in float32."""
    return _projector(h, int(h * ratio), device)


@functools.lru_cache(maxsize=None)
def _projector(h: int, cutoff: int, device: str) -> torch.Tensor:
    dc = _dct_matrix_np(h)[:cutoff]
    return torch.tensor(dc.T @ dc, dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# Plain versions (the CPU path and the kernels' reference on the card)
# --------------------------------------------------------------------------


def _lowpass_plain(y: torch.Tensor, D: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    coef = (D @ y @ D.T) * M
    return D.T @ coef @ D


def fused_trigger_fwd_plain(x, noise, B, D, M, noise_rate: float):
    low = _lowpass_plain((noise + 1.0) * 127.5, D, M) * (2.0 / 255.0) - 1.0
    u = x + low * noise_rate
    return B @ u.clamp(-1.0, 1.0) @ B.T, u


def fused_trigger_bwd_plain(g, u, B, D, M, noise_rate: float):
    gu = (B.T @ g @ B) * ((u >= -1.0) & (u <= 1.0)).to(g.dtype)
    return gu, _lowpass_plain(gu, D, M) * noise_rate


def low_freq_plain(x, D, M):
    return _lowpass_plain((x + 1.0) * 127.5, D, M) * (2.0 / 255.0) - 1.0


# --------------------------------------------------------------------------
# Wrappers: plain version for a CPU tensor, the kernel for a CUDA tensor
# --------------------------------------------------------------------------


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"trigger kernels need all operands on one device, got {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"trigger kernels run on CUDA or CPU tensors, got {device}")
    return False


def _check_cuda(planes: torch.Tensor) -> Tuple[int, int]:
    """Validate an (N, C, H, H) batch for a launch; returns (number of
    planes, H)."""
    if planes.dim() != 4 or planes.shape[-1] != planes.shape[-2]:
        raise ValueError(f"trigger kernels take square NCHW batches, got {tuple(planes.shape)}")
    h = planes.shape[-1]
    if planes.dtype != torch.float32 or not planes.is_contiguous():
        raise ValueError("trigger kernels take contiguous float32 tensors")
    return planes.shape[0] * planes.shape[1], h


def _check_trigger(a: torch.Tensor, b: torch.Tensor, taps: torch.Tensor, Dc: torch.Tensor) -> int:
    """Validate the operands of K1/K2 on any device; returns H."""
    if a.dim() != 4 or a.shape[-1] != a.shape[-2] or b.shape != a.shape:
        raise ValueError(f"the fused trigger takes two square NCHW batches of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    h = a.shape[-1]
    if taps.dim() != 1 or taps.numel() < 1 or taps.numel() // 2 >= h:
        raise ValueError(f"blur of {taps.numel()} taps on {h}px planes: needs kernel_size // 2 < H")
    if Dc.dim() != 2 or Dc.shape[1] != h or Dc.shape[0] > h:
        raise ValueError(f"D_c of shape {tuple(Dc.shape)} is not (c <= {h}, {h})")
    return h


def _launch_trigger(lib, a, b, taps, Dc, noise_rate: float, name: str):
    """K1 (``name`` fused_trigger_fwd) or K2 on a CUDA batch: the
    one-plane-per-block kernel up to 64 px, else the tiled chain with the
    projector P and a workspace.  One launch counted either way."""
    n_planes, h = _check_cuda(a)
    for t in (b, taps, Dc):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("trigger kernels take contiguous float32 tensors")
    o0, o1 = torch.empty_like(a), torch.empty_like(a)
    c, k = Dc.shape[0], taps.numel()
    if h <= PLANE_PER_BLOCK_MAX:
        err = getattr(lib, f"combat_{name}")(
            a.data_ptr(), b.data_ptr(), Dc.data_ptr(), taps.data_ptr(), o0.data_ptr(), o1.data_ptr(),
            n_planes, h, c, k, float(noise_rate), _stream(),
        )
    else:
        P, ws = _projector(h, c, str(a.device)), torch.empty_like(a)
        err = getattr(lib, f"combat_{name}_tiled")(
            a.data_ptr(), b.data_ptr(), P.data_ptr(), taps.data_ptr(), o0.data_ptr(), o1.data_ptr(), ws.data_ptr(),
            n_planes, h, c, k, float(noise_rate), _stream(),
        )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return o0, o1


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _plain_operands(h: int, taps: torch.Tensor, Dc: torch.Tensor):
    """The dense (B, D, M) that the plain versions take, from the taps and D_c."""
    D, M = _dense_operands(h, Dc.shape[0], str(Dc.device))
    return blur_matrix(taps, h), D, M


def fused_trigger_fwd(x, noise, taps, Dc, noise_rate: float):
    """K1: (out, u) for the NCHW batch ``x`` and generator output ``noise``;
    ``taps`` are the blur's k taps and ``Dc`` the truncated DCT matrix."""
    h = _check_trigger(x, noise, taps, Dc)
    if _on_cpu(x, noise, taps, Dc):
        return fused_trigger_fwd_plain(x, noise, *_plain_operands(h, taps, Dc), noise_rate)
    return _launch_trigger(build(), x, noise, taps, Dc, noise_rate, "fused_trigger_fwd")


def fused_trigger_bwd(g, u, taps, Dc, noise_rate: float):
    """K2: (g_x, g_noise) for the cotangent ``g`` of K1's output."""
    h = _check_trigger(g, u, taps, Dc)
    if _on_cpu(g, u, taps, Dc):
        return fused_trigger_bwd_plain(g, u, *_plain_operands(h, taps, Dc), noise_rate)
    return _launch_trigger(build(), g, u, taps, Dc, noise_rate, "fused_trigger_bwd")


def low_freq_planes(x, ratio: float):
    """K3: the DCT low-pass of an NCHW batch in [-1, 1] that keeps the c x c
    corner of the coefficients, ``c = int(H*ratio)``.  Needs c >= 1: at
    c = 0 the low-pass is the constant -1, which ``ops/dct.py::low_freq``
    returns without a kernel."""
    h = x.shape[-1]
    if int(h * ratio) < 1:
        raise ValueError(f"ratio {ratio} keeps no DCT coefficient at {h}px: low_freq returns -1 there")
    if _on_cpu(x):
        return low_freq_plain(x, *trigger_operands(h, ratio, str(x.device)))
    n_planes, h = _check_cuda(x)
    P = lowpass_projector(h, ratio, str(x.device))
    out = torch.empty_like(x)
    if h <= PLANE_PER_BLOCK_MAX:
        err = build().combat_low_freq(x.data_ptr(), P.data_ptr(), out.data_ptr(), n_planes, h, _stream())
    else:
        ws = torch.empty_like(x)
        err = build().combat_low_freq_tiled(x.data_ptr(), P.data_ptr(), out.data_ptr(), ws.data_ptr(), n_planes, h,
                                            _stream())
    _raise_on(err, "low_freq")
    LAUNCHES["low_freq"] += 1
    return out


class FusedTrigger(torch.autograd.Function):
    """``blur(clamp(x + low_freq(noise)*noise_rate, -1, 1))``: forward K1,
    backward K2.  ``taps`` (the blur for a drawn sigma) get no gradient, as
    the JAX package's custom VJP gives B none."""

    @staticmethod
    def forward(ctx, x, noise, taps, Dc, noise_rate: float):
        out, u = fused_trigger_fwd(x.contiguous(), noise.contiguous(), taps, Dc, noise_rate)
        ctx.save_for_backward(u, taps, Dc)
        ctx.noise_rate = noise_rate
        return out

    @staticmethod
    def backward(ctx, g):
        u, taps, Dc = ctx.saved_tensors
        gx, gn = fused_trigger_bwd(g.contiguous(), u, taps, Dc, ctx.noise_rate)
        return gx, gn, None, None, None


class LowFreq(torch.autograd.Function):
    """DCT low-pass: K3 forward, and K3 on the cotangent backward (the map is
    self-adjoint once the DC coefficient passes the mask)."""

    @staticmethod
    def forward(ctx, x, ratio: float):
        ctx.ratio = ratio
        return low_freq_planes(x.contiguous(), ratio)

    @staticmethod
    def backward(ctx, g):
        return low_freq_planes(g.contiguous(), ctx.ratio), None
