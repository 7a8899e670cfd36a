"""The rate at which one card issues ``mma.sync`` m16n8k8 TF32, the tensor-core
instruction of the port's tiled products (``combat_tpu_torch/csrc/
trigger_tiled.cuh::mma_tf32``): the ceiling of any kernel built on it, beside
the card's dense TF32 peak.

Each warp runs eight independent accumulators through ``iters`` rounds of
the header's own ``mma_tf32``, with no loads, at 1, 2 and 4 blocks of 256
threads an SM.  Prints the card's name and power limit, then one line a grid
(microseconds by CUDA events, TFLOP/s counting 2 x 16 x 8 x 8 an mma).  Needs
a CUDA card and ``nvcc``; builds into ``build/mma_tf32_rate/``:

    python scripts/mma_tf32_rate.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
#include "trigger_tiled.cuh"

__global__ void __launch_bounds__(256) mma_rate(float* out, int iters) {
  float c[8][4] = {};
  uint32_t a[4], b[2];
  for (int q = 0; q < 4; ++q) a[q] = tiled::to_tf32(threadIdx.x * 0.001f + q);
  for (int q = 0; q < 2; ++q) b[q] = tiled::to_tf32(threadIdx.x * 0.002f + q);
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int r = 0; r < 8; ++r) tiled::mma_tf32(c[r], a, b);
  float s = 0.f;
  for (int r = 0; r < 8; ++r)
    for (int q = 0; q < 4; ++q) s += c[r][q];
  if (s == 12345.f) out[threadIdx.x] = s;  // keeps the mma live
}

extern "C" int mma_rate_launch(void* out, int blocks, int iters, void* stream) {
  mma_rate<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    import torch

    from combat_tpu_torch.ops import trigger_kernels as tk

    if not torch.cuda.is_available():
        print("mma_tf32_rate: torch sees no CUDA device", file=sys.stderr)
        return 2
    out_dir = REPO / "build" / "mma_tf32_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, so = out_dir / "mma_rate.cu", out_dir / "libmma_rate.so"
    src.write_text(_SOURCE)
    cmd = [tk._nvcc(), *tk._NVCC_FLAGS, "-I", str(REPO / "combat_tpu_torch" / "csrc"), "-o", str(so), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.mma_rate_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.mma_rate_launch.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    sink = torch.empty(256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters, reps = 4000, 10
    for blocks in (sms, 2 * sms, 4 * sms):
        def launch():
            if lib.mma_rate_launch(sink.data_ptr(), blocks, iters, stream):
                raise SystemExit("mma_rate launch failed")

        launch()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        torch.cuda.synchronize()
        us = start.elapsed_time(end) / reps * 1e3
        flops = blocks * (256 // 32) * iters * 8 * 2 * 16 * 8 * 8
        print(f"mma.sync m16n8k8 TF32, {blocks} blocks x 256 threads: {us:.1f} us, {flops / us / 1e6:.1f} TFLOP/s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
