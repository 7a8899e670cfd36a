// K1-K3 for planes above 64 px (imagenet10's 224 px): tiled kernels, included
// by trigger.cu, whose one-plane-per-block kernels take H <= 64.
//
// Why another design: a 224 x 224 float32 plane is 200,704 B, and so is the
// projector P = D_c^T D_c at 224; a block has at most 227 KB of shared
// memory, so one block cannot hold a plane and its operator together.  Here
// every logical kernel is a short chain of launches over the whole batch,
// with one workspace of planes x H x H floats that the wrapper allocates
// (19.3 MB at bs 32, 3 x 224 x 224: it stays in the 50 MB L2):
//
//   K3  Z = X P;               out = P Z
//   K1  Z = N P;               u = x + noise_rate * (P Z + shift)   (written)
//       R = clip(u, -1, 1) B^T;  out = B R
//   K2  R = g B;               g_u = (B^T R) * 1{-1 <= u <= 1}      (g_x)
//       Z = g_u P;             g_n = noise_rate * P Z
//
// P Y P is the masked low-pass D^T((D y D^T) o M)D once the DC passes the
// mask (c >= 1), and the affine pre- and post-scaling of the JAX kernels
// folds away; at c = 0, P = 0 and K1's shift is -1 (low = -1).
//
// The products: one kernel, C_b = A_b B_b for every plane b, with A or B
// the shared P (plane stride 0).  A block computes a 64 x 64 output tile,
// 256 threads with a 4 x 4 register tile each; K advances in slices of 16
// staged through shared memory (A's slice transposed, so a thread reads its
// four rows as one float4).  Full float32 FMA, no TF32.  Edges past H are
// zero-filled on load and skipped on store, so any H works.  The epilogue
// writes alpha * (acc + shift) + addend, which gives K1's u and K2's g_n
// without another pass.
//
// The blur: B is the reflect-padded k-tap blur of ops/blur.py::blur_matrix,
// B[m][s] = sum_t taps[t] [refl(m + t - p) == s], p = k / 2.  A band pass
// computes one output element a thread, along one axis:
//   forward  v[q] = sum_t taps[t] s[refl(q + t - p)]                (B s)
//   adjoint  v[q] = sum_t taps[t] (s[q + p - t]
//                    + [q > 0] s[p - t - q] + [q < H-1] s[2(H-1) - q + p - t])   (B^T s)
// each term only where its index lies in [0, H): the three ways refl can
// land on q.  B^T is not the flipped stencil at the reflect borders, and
// this gather is exact there.  The pass reads its source from L2/L1 (no
// shared memory), so any k with k / 2 < H works.
//
// Bound at 224 px, bs 32 (96 planes) on an H100 SXM: the two products of a
// plane are 2 H^3 = 22.5 M FMA, 4.32 GFLOP a batch for K3 (0.064 ms at 67
// TFLOP/s of f32 FMA), 4.37 for K1/K2 with the 3-tap band (0.065 ms); K1/K2
// move 77.1 MB (0.023 ms at 3.35 TB/s), K3 38.5 MB.  So these kernels are
// bound by operations, where the 32 px ones are bound by bytes.

namespace tiled {

constexpr int kTile = 64;   // output tile edge of the products
constexpr int kSlice = 16;  // K slice staged through shared memory
constexpr int kThreads = 256;
constexpr int kMaxPlanesPerLaunch = 65535;  // gridDim.y

// C_b = alpha * (A_b B_b + shift) (+ addend_b) for the planes b of the
// launch; A_b = A + b * a_stride, likewise B and C (H x H, row-major).
__global__ void __launch_bounds__(kThreads) product_kernel(const float* __restrict__ A, long long a_stride,
                                                           const float* __restrict__ B, long long b_stride,
                                                           float* __restrict__ C, const float* __restrict__ addend,
                                                           int H, int tiles_n, float alpha, float shift) {
  __shared__ __align__(16) float As[kSlice][kTile + 4];  // As[k][i] = A[i0 + i][k0 + k]
  __shared__ __align__(16) float Bs[kSlice][kTile + 4];  // Bs[k][j] = B[k0 + k][j0 + j]
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int i0 = (blockIdx.x / tiles_n) * kTile, j0 = (blockIdx.x % tiles_n) * kTile;
  const size_t plane = blockIdx.y, n = static_cast<size_t>(H) * H;
  const float* a = A + plane * a_stride;
  const float* b = B + plane * b_stride;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = 0.f;

  for (int k0 = 0; k0 < H; k0 += kSlice) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // A: 64 rows x 16 depths, consecutive threads along a row
      const int row = t / 16 + 16 * r, kk = t % 16, gi = i0 + row, gk = k0 + kk;
      As[kk][row] = (gi < H && gk < H) ? a[static_cast<size_t>(gi) * H + gk] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // B: 16 depths x 64 columns, consecutive threads along a row
      const int kk = t / 64 + 4 * r, col = t % 64, gk = k0 + kk, gj = j0 + col;
      Bs[kk][col] = (gk < H && gj < H) ? b[static_cast<size_t>(gk) * H + gj] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlice; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w}, bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(ar[r], bs[s], acc[r][s]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= H) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = j0 + tx * 4 + s;
      if (j >= H) continue;
      const size_t idx = plane * n + static_cast<size_t>(i) * H + j;
      float v = alpha * (acc[r][s] + shift);
      if (addend != nullptr) v += addend[idx];
      C[idx] = v;
    }
  }
}

__device__ __forceinline__ int reflect(int r, int H) {
  r = abs(r);
  return r > H - 1 ? 2 * (H - 1) - r : r;
}

// One band pass of the blur along rows (Rows: the gather runs over i, as
// B s) or columns (s B^T), forward or adjoint (B^T s, s B), over `planes`
// H x H planes; one thread per output element.  `clip` clamps each source
// value to [-1, 1] (K1's clip(u)); `mask`, when given, zeroes the outputs
// where mask lies outside [-1, 1] (K2's 1{-1 <= u <= 1}).
template <bool Rows, bool Adjoint>
__global__ void __launch_bounds__(kThreads) band_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                                        const float* __restrict__ taps, const float* __restrict__ mask,
                                                        int H, int k, size_t total, bool clip) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t n = static_cast<size_t>(H) * H, base = idx / n * n;
  const int e = static_cast<int>(idx - base), i = e / H, j = e - i * H;
  const int q = Rows ? i : j, p = k / 2;
  // the source element at position r along the pass's axis
  auto at = [&](int r) {
    const float v = src[base + (Rows ? static_cast<size_t>(r) * H + j : static_cast<size_t>(i) * H + r)];
    return clip ? fminf(fmaxf(v, -1.f), 1.f) : v;
  };
  float acc = 0.f;
  for (int t = 0; t < k; ++t) {
    const float w = taps[t];
    if (!Adjoint) {
      acc = fmaf(w, at(reflect(q + t - p, H)), acc);
    } else {
      const int r1 = q + p - t, r2 = p - t - q, r3 = 2 * (H - 1) - q + p - t;
      if (r1 >= 0 && r1 < H) acc = fmaf(w, at(r1), acc);
      if (q > 0 && r2 >= 0 && r2 < H) acc = fmaf(w, at(r2), acc);
      if (q < H - 1 && r3 >= 0 && r3 < H) acc = fmaf(w, at(r3), acc);
    }
  }
  if (mask != nullptr) {
    const float m = mask[idx];
    acc = (m >= -1.f && m <= 1.f) ? acc : 0.f;
  }
  dst[idx] = acc;
}

}  // namespace tiled
