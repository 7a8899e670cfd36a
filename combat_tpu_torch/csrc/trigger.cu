// Trigger-chain kernels for Hopper (sm_90a): the port of the three Pallas
// TPU kernels in combat_tpu/ops/pallas_kernels.py.
//
//   K1 combat_fused_trigger_fwd   <- _fused_trigger_fwd_kernel / _fused_trigger_impl
//   K2 combat_fused_trigger_bwd   <- _fused_trigger_bwd_kernel / _fused_trigger_vjp_bwd
//   K3 combat_low_freq            <- _low_freq_kernel / _low_freq_pallas_impl
//
// Every (image, channel) plane of an NCHW float32 batch is contiguous, so a
// block works on whole planes and needs no transposes.  All products here
// are full float32 FMA: no TF32, because the port is held to the JAX package
// at the 1e-5 level and the low-pass sees values up to 255 (the tiled
// kernels above 64 px use the tensor cores in three TF32 passes, which keep
// that accuracy).
//
// Bound at the slice's shapes (384 planes of 32x32, cutoff c = 20, 3 taps):
// K1 and K2 read two 1.57 MB arrays and write two, 6.3 MB or ~1.88 us at
// 3.35 TB/s; the ~57 MFLOP they need take ~0.9 us at 67 TFLOP/s, so they are
// bound by bytes.  K3 moves 3.1 MB, ~0.94 us.
//
// What held the first K1-K3 design back: one block of 256 threads per
// plane ran six (K3: four) dense H^3 products, each FMA
// loading both operands from shared memory, ~12 k warp-wide shared loads per
// plane, ~36 k per SM at 384 planes, ~20 us of the 29 us each kernel took;
// and it did 2.7x the work the function needs, since the mask keeps only the
// c x c corner of the coefficients and the blur is a k-tap band.
//
// K1/K2 now:
//   1. take D_c, the first c rows of the DCT matrix: the low-pass is
//      D_c^T (D_c y D_c^T) D_c, four products of depth H or c and no mask.
//      Its affine pre- and post-scaling cancels (the all-ones plane passes
//      unchanged once the DC does), so K1 low-passes n itself;
//   2. take the k taps and apply the reflect-padded blur as a band of 2p+1
//      weights per row (p = k/2), built once per block from the same reflect
//      rule as blur_matrix, with the tap loop unrolled for 3 and 5 taps.  B^T
//      is not the flipped stencil at the borders: its band is read off B's
//      entries, so B^T g B is exact;
//   3. tile the products in registers (2x2 at H <= 32, 4x4 above): a thread
//      reads a float4 of A's row, broadcast to the lanes that share it, and
//      one float of B per column, so each loaded value feeds two or four
//      FMAs; matrices have a row stride of round4(H) + 4, so rows start in
//      different banks, and zero padding makes every depth a multiple of 4;
//   4. copy D_c, D_c^T and the plane's two inputs into shared memory with
//      cp.async, in one group, so the block's set-up (zero padding, the
//      band) runs while they arrive.  One plane per block: 384 planes give
//      ~2.9 blocks per SM.  Looping over several planes per block, with the
//      next plane's inputs copied while one computes, was slower on an H100
//      at 384 planes (0.0115-0.0157 ms against 0.0093 ms) and pays off only
//      at batches no configuration trains with (bs >= 264).
//
// Measured on an H100 (chip_smoke.py's torch.profiler trace): at the
// slice's shapes each kernel runs ~8.4 us on the device (the first design
// took ~29 us by CUDA events), ~22% of its bound.  With one block per SM it
// still takes ~5.5 us: the latency of a block's dependent chain (four
// products, two band passes, seven barriers) sets most of the time, and the
// 2-3 blocks sharing an SM at 384 planes the rest.
//
// K3 is bound the same way, and its design shortens the chain instead:
//   5. the low-pass is P y P with the projector P = D_c^T D_c (H x H,
//      symmetric, built in float64 by the wrapper), two products of depth H
//      with one barrier between them in place of four products and three
//      barriers.  At H = 32, c = 20 that is 65,536 FMA a plane against the
//      truncated chain's 66,560, so the work is the same and the chain half
//      as long.  The affine scaling folds away as in K1, so the same map
//      serves forward and backward;
//   6. the products reuse K1/K2's register tiles (2x2 at H = 32, 4x4 at 64:
//      256 tiles each, one per thread), P and the plane arrive by cp.async,
//      and shared memory holds three H x (H+4) matrices (13.8 KB at H = 32)
//      where the first design staged four H x (H+1) ones: D, the mask and
//      two work planes.
// Measured on an H100 (chip_smoke.py): ~6.0 us on the device at the
// slice's shapes (the first design took ~20 us by CUDA events), ~15% of its
// bound; with one block per SM 3.2 us, against K1/K2's 5.5 us.  The ~2.9 us
// that 2-3 blocks an SM add is likely the shared-memory loads of the 2x2
// tiles (2.5 load wavefronts a warp per 4 FMAs a lane), not yet measured.
//
// Planes above 64 px (imagenet10's 224) take the tiled kernels of
// trigger_tiled.cuh: the same three functions as chains of batched
// tensor-core products with P (three TF32 passes), K1's blur and K2's
// adjoint blur each in one pass, each logical kernel one entry point
// (combat_*_tiled) and one wrapper call.
//
// Plain C interface, loaded with ctypes; every entry point returns
// cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "trigger_tiled.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxH = 64;

// ---------------------------------------------------------------------------
// K1 / K2
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }  // floats to 16 bytes

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Start copying n contiguous floats into shared memory (16-byte copies when
// n and the source allow it).
__device__ __forceinline__ void copy_async(float* dst, const float* __restrict__ src, int n, bool vec) {
  if (vec) {
    for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4) cp_async16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i);
  }
}

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// out(i, j) = sum_{k < K} A[i*lda + k] * B[k*ldb + j] for an M x N output,
// each thread accumulating a TM x TN tile in registers.  K is a multiple of
// 4: A's row is read as float4 (rows zero-padded past the true depth, B's
// padded rows zero).  The tile's rows are ti + r*ceil(M/TM) and its columns
// tj + s*ceil(N/TN), so consecutive lanes read consecutive columns of B and
// share A's rows (a broadcast).  Rows and columns past the edge are clamped
// for the loads and skipped by the epilogue, epi(i, j, value).
template <int TM, int TN, class Epi>
__device__ __forceinline__ void tiled_product(int M, int N, int K, const float* A, int lda, const float* B, int ldb,
                                              Epi epi) {
  const int ms = (M + TM - 1) / TM, ns = (N + TN - 1) / TN;
  for (int t = threadIdx.x; t < ms * ns; t += blockDim.x) {
    const int ti = t / ns, tj = t - ti * ns;
    const float* a[TM];
    const float* b[TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) a[r] = A + min(ti + r * ms, M - 1) * lda;
#pragma unroll
    for (int s = 0; s < TN; ++s) b[s] = B + min(tj + s * ns, N - 1);
    float acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int s = 0; s < TN; ++s) acc[r][s] = 0.f;
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      float4 av[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) av[r] = *reinterpret_cast<const float4*>(a[r] + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[TN];
#pragma unroll
        for (int s = 0; s < TN; ++s) bv[s] = b[s][(k + kk) * ldb];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int s = 0; s < TN; ++s) acc[r][s] = fmaf(component(av[r], kk), bv[s], acc[r][s]);
      }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int i = ti + r * ms;
      if (i >= M) continue;
#pragma unroll
      for (int s = 0; s < TN; ++s) {
        const int j = tj + s * ns;
        if (j < N) epi(i, j, acc[r][s]);
      }
    }
  }
}

// f(i, j) for every i, j < H, one warp per row and one lane per column.
template <class F>
__device__ __forceinline__ void for_each_element(int H, F f) {
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < H; i += nwarps)
    for (int j = lane; j < H; j += 32) f(i, j);
}

// B[m][s] of the reflect-padded k-tap blur, summed in tap order as
// blur_matrix sums it (0 when s is no source of row m).
__device__ __forceinline__ float blur_entry(const float* __restrict__ taps, int k, int H, int m, int s) {
  const int p = k / 2;
  float w = 0.f;
  for (int t = 0; t < k; ++t) {
    int r = abs(m + t - p);
    if (r > H - 1) r = 2 * (H - 1) - r;
    if (r == s) w += taps[t];
  }
  return w;
}

// The blur as a band of 2p+1 weights per row (every reflected source of row
// m lies within p of m): W[d*H + i] = B[i][i+d-p], or with `transposed`
// B^T[i][i+d-p] = B[i+d-p][i].  B^T is not the flipped stencil at the
// borders; reading its band off B keeps B^T g B exact.
__device__ __forceinline__ void build_band(const float* __restrict__ taps, float* W, int H, int k, bool transposed) {
  const int p = k / 2, kb = 2 * p + 1;
  for (int idx = threadIdx.x; idx < kb * H; idx += blockDim.x) {
    const int d = idx / H, i = idx - d * H;  // set-up, once per block
    const int m = i + d - p;
    W[idx] = (m < 0 || m >= H) ? 0.f : transposed ? blur_entry(taps, k, H, m, i) : blur_entry(taps, k, H, i, m);
  }
}

// sum_d W[d*H + i] * src(clamp(i + d - p)): one output of a band product,
// with the band width KB known at compile time (KB > 0) or kb.  Weights past
// the edge are 0; the clamp only keeps the read in the plane.
template <int KB, class Src>
__device__ __forceinline__ float band_dot(const float* W, int H, int kb, int i, Src src) {
  const int n = KB > 0 ? KB : kb, p = n / 2;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < n; ++d) acc = fmaf(W[d * H + i], src(min(max(i + d - p, 0), H - 1)), acc);
  return acc;
}

// f(std::integral_constant<int, KB>()): the band width as a compile-time
// constant for the common 3- and 5-tap blurs, 0 (read kb) for the others.
template <class F>
__device__ __forceinline__ void with_band_width(int kb, F f) {
  if (kb == 3) f(std::integral_constant<int, 3>());
  else if (kb == 5) f(std::integral_constant<int, 5>());
  else f(std::integral_constant<int, 0>());
}

// Shared-memory layout of K1/K2, in floats.  Matrices have the row stride
// ld = round4(H) + 4: a multiple of 4 for float4 rows, and rows that start
// in different banks.  Depths are zero-padded to multiples of 4.  One work
// matrix holds, in turn, the three intermediates whose lives do not overlap
// (K1: D_c y, then D_c^T Cm, then the row blur; K2: the row blur, then
// D_c g_u, then D_c^T Cm).
struct Layout {
  int H4, c4, ld, dc, dct, band, work, cm, pl, in, half, end;
  __host__ __device__ Layout(int H, int c, int k) {
    H4 = round4(H);
    c4 = round4(c);
    ld = H4 + 4;
    dc = 0;                                     // D_c, c4 x ld
    dct = dc + c4 * ld;                         // D_c^T, H4 x ld
    band = dct + H4 * ld;                       // the blur's band, (2p+1) x H
    work = band + round4((2 * (k / 2) + 1) * H);  // H4 x ld
    cm = work + H4 * ld;                        // coefficients D_c y D_c^T, c4 x ld
    pl = cm + c4 * ld;                          // the clamped plane (K1) or g_u (K2), H4 x ld
    in = pl + H4 * ld;                          // the two inputs, dense H4 x H planes
    half = round4(H4 * H);
    end = in + 2 * half;
  }
};

// Per-block set-up: start copying D_c and D_c^T into shared memory (element
// by element with cp.async, so no thread waits on a load), write the zero
// padding, zero the intermediates and the tails of the input buffers (rows
// H..H4-1, which cp.async never writes), and build the blur's band, whose
// loads of the taps overlap the copies.  Padding that a later intermediate
// overwrites is cleared again where it is needed (lowpass_tail).  Then the
// block's plane of the two inputs a and b joins the copies in one group,
// and the block waits for all of it.
__device__ __forceinline__ void setup_block(float* smem, const Layout& L, const float* __restrict__ Dc,
                                            const float* __restrict__ taps, const float* __restrict__ a,
                                            const float* __restrict__ b, int H, int c, int k, bool transposed) {
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5, ld = L.ld;
  for (int i = threadIdx.x >> 5; i < L.c4; i += nwarps)
    for (int j = lane; j < ld; j += 32) {
      float* dst = smem + L.dc + i * ld + j;
      if (i < c && j < H) cp_async4(dst, Dc + i * H + j);
      else *dst = 0.f;
    }
  for (int i = threadIdx.x >> 5; i < L.H4; i += nwarps)
    for (int j = lane; j < ld; j += 32) {
      float* dst = smem + L.dct + i * ld + j;
      if (i < H && j < c) cp_async4(dst, Dc + j * H + i);
      else *dst = 0.f;
    }
  build_band(taps, smem + L.band, H, k, transposed);
  for (int i = L.work + threadIdx.x; i < L.in; i += blockDim.x) smem[i] = 0.f;
  const int n = H * H, tail = (L.H4 - H) * H;
  for (int i = threadIdx.x; i < tail; i += blockDim.x) smem[L.in + n + i] = smem[L.in + L.half + n + i] = 0.f;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const bool vec = (n & 3) == 0 && ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  copy_async(smem + L.in, a + base, n, vec);
  copy_async(smem + L.in + L.half, b + base, n, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// The truncated low-pass of the plane held in T1 = D_c y (c x H, in the
// work matrix), up to its last product: Cm = T1 D_c^T; T2 = D_c^T Cm (over
// T1, with its padding columns c..c4-1 cleared of what T1 left there);
// epi(i, j, (T2 D_c)(i, j)).
template <int TM, int TN, class Epi>
__device__ __forceinline__ void lowpass_tail(float* smem, const Layout& L, int H, int c, Epi epi) {
  const float* sD = smem + L.dc;
  const float* sDt = smem + L.dct;
  float* W = smem + L.work;
  float* Cm = smem + L.cm;
  const int ld = L.ld, pad = L.c4 - c;
  tiled_product<TM, TN>(c, c, L.H4, W, ld, sDt, ld, [&](int i, int j, float v) { Cm[i * ld + j] = v; });
  __syncthreads();
  tiled_product<TM, TN>(H, c, L.c4, sDt, ld, Cm, ld, [&](int i, int j, float v) { W[i * ld + j] = v; });
  for (int idx = threadIdx.x; idx < H * pad; idx += blockDim.x) W[(idx / pad) * ld + c + idx % pad] = 0.f;
  __syncthreads();
  tiled_product<TM, TN>(H, H, L.c4, W, ld, sD, ld, epi);
}

// K1, per plane: low = D_c^T (D_c n D_c^T) D_c, which equals the JAX
// kernel's ((n+1)*127.5 low-passed)*2/255 - 1: the low-pass is linear and
// maps the all-ones plane to itself once the DC passes (c >= 1); at c = 0
// low is -1.  u = x + noise_rate*low (written for the backward pass);
// out = B clip(u, -1, 1) B^T with B the k-tap reflect-padded band.
// HC is H when it is known at compile time (strides become immediates), else 0.
template <int TM, int TN, int HC>
__global__ void __launch_bounds__(kThreads) fused_trigger_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ nz, const float* __restrict__ Dc,
    const float* __restrict__ taps, float* __restrict__ out, float* __restrict__ u, int H_, int c, int k,
    float noise_rate) {
  extern __shared__ __align__(16) float smem[];
  const int H = HC ? HC : H_;
  const Layout L(H, c, k);
  const int ld = L.ld, n = H * H, kb = 2 * (k / 2) + 1;
  const float* sD = smem + L.dc;
  const float* sW = smem + L.band;
  float* T1 = smem + L.work;
  float* R = T1;  // the row blur's output, in the work matrix
  float* P = smem + L.pl;
  const float* sX = smem + L.in;
  const float* sN = sX + L.half;
  float* o = out + static_cast<size_t>(blockIdx.x) * n;
  float* uo = u + static_cast<size_t>(blockIdx.x) * n;
  const float shift = c > 0 ? 0.f : -1.f;

  setup_block(smem, L, Dc, taps, x, nz, H, c, k, false);  // ends with a barrier
  tiled_product<TM, TN>(c, H, L.H4, sD, ld, sN, H, [&](int i, int j, float v) { T1[i * ld + j] = v; });
  __syncthreads();
  lowpass_tail<TM, TN>(smem, L, H, c, [&](int i, int j, float v) {
    const float uu = sX[i * H + j] + (v + shift) * noise_rate;
    uo[i * H + j] = uu;
    P[i * ld + j] = fminf(fmaxf(uu, -1.f), 1.f);
  });
  __syncthreads();
  with_band_width(kb, [&](auto KB) {
    for_each_element(H, [&](int i, int j) {  // R = B P: the band along the rows axis
      R[i * ld + j] = band_dot<decltype(KB)::value>(sW, H, kb, i, [&](int m) { return P[m * ld + j]; });
    });
    __syncthreads();
    for_each_element(H, [&](int i, int j) {  // out = R B^T: the band along the columns axis
      o[i * H + j] = band_dot<decltype(KB)::value>(sW, H, kb, j, [&](int m) { return R[i * ld + m]; });
    });
  });
}

// K2, the adjoint of K1, per plane: g_u = (B^T g B) * 1{-1 <= u <= 1};
// g_x = g_u; g_n = noise_rate * D_c^T (D_c g_u D_c^T) D_c.
template <int TM, int TN, int HC>
__global__ void __launch_bounds__(kThreads) fused_trigger_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ u, const float* __restrict__ Dc,
    const float* __restrict__ taps, float* __restrict__ gx, float* __restrict__ gn, int H_, int c, int k,
    float noise_rate) {
  extern __shared__ __align__(16) float smem[];
  const int H = HC ? HC : H_;
  const Layout L(H, c, k);
  const int ld = L.ld, n = H * H, kb = 2 * (k / 2) + 1;
  const float* sD = smem + L.dc;
  const float* sWt = smem + L.band;
  float* T1 = smem + L.work;
  float* R = T1;  // B^T g, in the work matrix: dead before T1 is written
  float* P = smem + L.pl;
  const float* sG = smem + L.in;
  const float* sU = sG + L.half;
  float* gxo = gx + static_cast<size_t>(blockIdx.x) * n;
  float* gno = gn + static_cast<size_t>(blockIdx.x) * n;

  setup_block(smem, L, Dc, taps, g, u, H, c, k, true);  // ends with a barrier
  with_band_width(kb, [&](auto KB) {
    for_each_element(H, [&](int i, int j) {  // R = B^T g
      R[i * ld + j] = band_dot<decltype(KB)::value>(sWt, H, kb, i, [&](int m) { return sG[m * H + j]; });
    });
    __syncthreads();
    for_each_element(H, [&](int i, int j) {  // g_u = (R B) * 1{-1 <= u <= 1}
      const float gc = band_dot<decltype(KB)::value>(sWt, H, kb, j, [&](int m) { return R[i * ld + m]; });
      const float uu = sU[i * H + j];
      const float gu = (uu >= -1.f && uu <= 1.f) ? gc : 0.f;
      gxo[i * H + j] = gu;
      P[i * ld + j] = gu;
    });
  });
  __syncthreads();
  tiled_product<TM, TN>(c, H, L.H4, sD, ld, P, ld, [&](int i, int j, float v) { T1[i * ld + j] = v; });
  __syncthreads();
  lowpass_tail<TM, TN>(smem, L, H, c, [&](int i, int j, float v) { gno[i * H + j] = v * noise_rate; });
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

// Start copying an H x H row-major matrix into shared memory with row stride
// ld (16-byte copies when H % 4 == 0 and the source is 16-byte aligned).
__device__ __forceinline__ void copy_plane_async(float* dst, int ld, const float* __restrict__ src, int H, bool vec) {
  if (vec) {
    const int q = H >> 2;
    for (int idx = threadIdx.x; idx < H * q; idx += blockDim.x) {
      const int i = idx / q, j = (idx - i * q) << 2;
      cp_async16(dst + i * ld + j, src + i * H + j);
    }
  } else {
    for (int idx = threadIdx.x; idx < H * H; idx += blockDim.x) {
      const int i = idx / H;
      cp_async4(dst + i * ld + idx - i * H, src + idx);
    }
  }
}

// K3, per plane: out = P x P with P = D_c^T D_c, which equals the JAX
// kernel's D^T((D y D^T) o M)D * 2/255 - 1 with y = (x+1)*127.5: the
// masked low-pass is D_c^T (D_c y D_c^T) D_c = P y P, it is linear, and P
// passes the all-ones plane once the DC does (c >= 1; the wrapper never
// launches at c = 0).  P is symmetric, so the map is self-adjoint and the
// backward pass launches this kernel on the cotangent.  Two register-tiled
// products with one barrier between them: T = x P, then out = P T, written
// straight to global memory.  Shared memory holds P, the plane and T, each
// H4 x ld with zero padding past H (rows and columns H..H4-1).
template <int TM, int TN, int HC>
__global__ void __launch_bounds__(kThreads) low_freq_kernel(const float* __restrict__ x, const float* __restrict__ P,
                                                            float* __restrict__ out, int H_) {
  extern __shared__ __align__(16) float smem[];
  const int H = HC ? HC : H_;
  const int H4 = round4(H), ld = H4 + 4, sz = H4 * ld;
  float* sP = smem;
  float* sX = sP + sz;
  float* T = sX + sz;
  const size_t base = static_cast<size_t>(blockIdx.x) * H * H;
  const bool vec = (H & 3) == 0 && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(P)) & 15) == 0;

  copy_plane_async(sP, ld, P, H, vec);
  copy_plane_async(sX, ld, x + base, H, vec);
  cp_async_commit();
  if (H4 > H) {  // the padding, which no copy writes (none at H = 32 or 64)
    for (int idx = threadIdx.x; idx < H4 * H4; idx += blockDim.x) {
      const int i = idx / H4, j = idx - i * H4;
      if (i >= H || j >= H) sP[i * ld + j] = sX[i * ld + j] = T[i * ld + j] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  tiled_product<TM, TN>(H, H, H4, sX, ld, sP, ld, [&](int i, int j, float v) { T[i * ld + j] = v; });
  __syncthreads();
  float* o = out + base;
  tiled_product<TM, TN>(H, H, H4, sP, ld, T, ld, [&](int i, int j, float v) { o[i * H + j] = v; });
}

size_t low_freq_smem_bytes(int H) { return static_cast<size_t>(3) * round4(H) * (round4(H) + 4) * sizeof(float); }

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

using TrigKernel = void (*)(const float*, const float*, const float*, const float*, float*, float*, int, int, int,
                            float);
using LowFreqKernel = void (*)(const float*, const float*, float*, int);

// Each kernel's instances by register tile (TM x TN) and compile-time H (HC).
struct FwdKernels {
  template <int TM, int TN, int HC>
  static TrigKernel get() { return fused_trigger_fwd_kernel<TM, TN, HC>; }
};
struct BwdKernels {
  template <int TM, int TN, int HC>
  static TrigKernel get() { return fused_trigger_bwd_kernel<TM, TN, HC>; }
};
struct LowFreqKernels {
  template <int TM, int TN, int HC>
  static LowFreqKernel get() { return low_freq_kernel<TM, TN, HC>; }
};

// Register tiles per plane size: 2 x 2 up to H = 32 (cifar10: K1/K2 have
// 100-256 tiles a product for 256 threads at c = 20, K3 256), 4 x 4 above
// (celeba, H = 64: 121-256 tiles at c = 41, K3 256).  H = 32 and 64 get
// compile-time strides.
template <class Kernels>
auto pick(int H) {
  if (H == 32) return Kernels::template get<2, 2, 32>();
  if (H == 64) return Kernels::template get<4, 4, 64>();
  return H < 32 ? Kernels::template get<2, 2, 0>() : Kernels::template get<4, 4, 0>();
}

template <bool Forward>
int launch_trigger(const void* a, const void* b, const void* Dc, const void* taps, void* o0, void* o1, int planes,
                   int H, int c, int k, float noise_rate, void* stream) {
  if (planes <= 0 || H < 1 || H > kMaxH || c < 0 || c > H || k < 1 || k / 2 >= H)
    return static_cast<int>(cudaErrorInvalidValue);
  const TrigKernel kernel = pick<std::conditional_t<Forward, FwdKernels, BwdKernels>>(H);
  const size_t bytes = static_cast<size_t>(Layout(H, c, k).end) * sizeof(float);
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<planes, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(Dc),
      static_cast<const float*>(taps), static_cast<float*>(o0), static_cast<float*>(o1), H, c, k, noise_rate);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Launchers of the tiled kernels (H > 64)
// ---------------------------------------------------------------------------

// C = alpha * ((A_b P)^T per plane + shift) (+ addend) for `planes` planes
// of A, with P given split in fragment order, Ps (tiled::product_kernel).
// Shared memory above 48 KB is opted into at every call, which costs a host
// call and no device time.
cudaError_t product(const float* A, const float* Ps, float* C, const float* addend, int planes, int H, float alpha,
                    float shift, cudaStream_t stream) {
  static int sms = 0;  // persistent blocks: one an SM
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const long long rows = static_cast<long long>(planes) * H;
  const int tiles_n = (H + tiled::kBN - 1) / tiled::kBN;
  const long long tiles_m = (rows + tiled::kBM - 1) / tiled::kBM;
  const int per_n = static_cast<int>(std::min<long long>(tiles_m, std::max(1, sms / tiles_n)));
  if ((reinterpret_cast<uintptr_t>(Ps) & 15) != 0) return cudaErrorMisalignedAddress;
  const bool vec = (H & 3) == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const cudaError_t err = prepare(tiled::product_kernel, tiled::kProductSmem);
  if (err != cudaSuccess) return err;
  tiled::product_kernel<<<per_n * tiles_n, tiled::kProductThreads, tiled::kProductSmem, stream>>>(
      A, Ps, C, addend, rows, H, tiles_n, per_n, alpha, shift, vec);
  return cudaGetLastError();
}

// The grid of blur_kernel and adjoint_kernel: one block a 56 x 32 output tile.
cudaError_t blur_grid(int planes, int H, int& tiles_i, int& tiles_j, unsigned& blocks) {
  tiles_i = (H + tiled::kBlurRows - 1) / tiled::kBlurRows;
  tiles_j = (H + tiled::kBlurCols - 1) / tiled::kBlurCols;
  const long long n = static_cast<long long>(tiles_i) * tiles_j * planes;
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  blocks = static_cast<unsigned>(n);
  return cudaSuccess;
}

// out = B clip(u, -1, 1) B^T (tiled::blur_kernel).
cudaError_t blur(const float* u, float* out, const float* taps, int planes, int H, int k, cudaStream_t stream) {
  int tiles_i, tiles_j;
  unsigned blocks;
  const cudaError_t err = blur_grid(planes, H, tiles_i, tiles_j, blocks);
  if (err != cudaSuccess) return err;
  tiled::blur_kernel<<<blocks, tiled::kBlurThreads, 0, stream>>>(u, out, taps, H, k, tiles_i, tiles_j);
  return cudaGetLastError();
}

// g_x = (B^T g B) * 1{-1 <= u <= 1} (tiled::adjoint_kernel).
cudaError_t adjoint(const float* g, const float* u, float* gx, const float* taps, int planes, int H, int k,
                    cudaStream_t stream) {
  int tiles_i, tiles_j;
  unsigned blocks;
  const cudaError_t err = blur_grid(planes, H, tiles_i, tiles_j, blocks);
  if (err != cudaSuccess) return err;
  tiled::adjoint_kernel<<<blocks, tiled::kBlurThreads, 0, stream>>>(g, u, gx, taps, H, k, tiles_i, tiles_j);
  return cudaGetLastError();
}

bool tiled_args_ok(int planes, int H, int c, int k) {
  return planes > 0 && H >= 1 && c >= 0 && c <= H && k >= 1 && k / 2 < H;
}

}  // namespace

extern "C" {

int combat_fused_trigger_fwd(const void* x, const void* nz, const void* Dc, const void* taps, void* out, void* u,
                             int planes, int H, int c, int k, float noise_rate, void* stream) {
  return launch_trigger<true>(x, nz, Dc, taps, out, u, planes, H, c, k, noise_rate, stream);
}

int combat_fused_trigger_bwd(const void* g, const void* u, const void* Dc, const void* taps, void* gx, void* gn,
                             int planes, int H, int c, int k, float noise_rate, void* stream) {
  return launch_trigger<false>(g, u, Dc, taps, gx, gn, planes, H, c, k, noise_rate, stream);
}

int combat_low_freq(const void* x, const void* P, void* out, int planes, int H, void* stream) {
  if (planes <= 0 || H < 1 || H > kMaxH) return static_cast<int>(cudaErrorInvalidValue);
  const LowFreqKernel kernel = pick<LowFreqKernels>(H);
  const size_t bytes = low_freq_smem_bytes(H);
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<planes, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(P), static_cast<float*>(out), H);
  return static_cast<int>(cudaGetLastError());
}

// K1 above 64 px: W = (N P)^T; u = x + noise_rate * ((W P)^T + shift);
// out = B clip(u) B^T.  `Ps` is P split into big and small TF32 parts in the
// products' fragment order (H x 2 Kp floats, Kp = 8 ceil(H / 8)); `ws` holds W
// (planes x H x H floats).
int combat_fused_trigger_fwd_tiled(const void* x, const void* nz, const void* Ps, const void* taps, void* out,
                                   void* u, void* ws, int planes, int H, int c, int k, float noise_rate,
                                   void* stream) {
  if (!tiled_args_ok(planes, H, c, k)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const float *fx = static_cast<const float*>(x), *fn = static_cast<const float*>(nz),
              *fP = static_cast<const float*>(Ps), *ft = static_cast<const float*>(taps);
  float *fo = static_cast<float*>(out), *fu = static_cast<float*>(u), *fw = static_cast<float*>(ws);
  cudaError_t err = product(fn, fP, fw, nullptr, planes, H, 1.f, 0.f, st);
  if (err == cudaSuccess) err = product(fw, fP, fu, fx, planes, H, noise_rate, c > 0 ? 0.f : -1.f, st);
  if (err == cudaSuccess) err = blur(fu, fo, ft, planes, H, k, st);
  return static_cast<int>(err);
}

// K2 above 64 px: g_u = (B^T g B) * 1{-1 <= u <= 1} in one pass, written as
// g_x; W = (g_u P)^T; g_n = noise_rate * (W P)^T.  `Ps` as in K1; `ws` holds
// W.
int combat_fused_trigger_bwd_tiled(const void* g, const void* u, const void* Ps, const void* taps, void* gx,
                                   void* gn, void* ws, int planes, int H, int c, int k, float noise_rate,
                                   void* stream) {
  if (!tiled_args_ok(planes, H, c, k)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const float *fg = static_cast<const float*>(g), *fu = static_cast<const float*>(u),
              *fP = static_cast<const float*>(Ps), *ft = static_cast<const float*>(taps);
  float *fgx = static_cast<float*>(gx), *fgn = static_cast<float*>(gn), *fw = static_cast<float*>(ws);
  cudaError_t err = adjoint(fg, fu, fgx, ft, planes, H, k, st);
  if (err == cudaSuccess) err = product(fgx, fP, fw, nullptr, planes, H, 1.f, 0.f, st);
  if (err == cudaSuccess) err = product(fw, fP, fgn, nullptr, planes, H, noise_rate, 0.f, st);
  return static_cast<int>(err);
}

// K3 above 64 px: W = (X P)^T; out = (W P)^T = P X P.  `Ps` as in K1; `ws`
// holds W.
int combat_low_freq_tiled(const void* x, const void* Ps, void* out, void* ws, int planes, int H, void* stream) {
  if (!tiled_args_ok(planes, H, 1, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const float* fP = static_cast<const float*>(Ps);
  float* fw = static_cast<float*>(ws);
  cudaError_t err = product(static_cast<const float*>(x), fP, fw, nullptr, planes, H, 1.f, 0.f, st);
  if (err == cudaSuccess) err = product(fw, fP, static_cast<float*>(out), nullptr, planes, H, 1.f, 0.f, st);
  return static_cast<int>(err);
}

}  // extern "C"
