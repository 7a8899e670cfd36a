// K1-K3 for planes above 64 px (imagenet10's 224 px): tiled kernels, included
// by trigger.cu, whose one-plane-per-block kernels take H <= 64.  They replace
// the Pallas TPU kernels of combat_tpu/ops/pallas_kernels.py above 64 px:
// _fused_trigger_fwd_kernel (K1), _fused_trigger_bwd_kernel (K2) and
// _low_freq_kernel (K3).
//
// Why tiles: a 224 x 224 float32 plane is 200,704 B, and so is the projector
// P = D_c^T D_c at 224; a block has at most 227 KB of shared memory, so one
// block cannot hold a plane and its operator together.  Every logical kernel
// is a short chain of launches over the whole batch, with one workspace of
// planes x H x H floats that the wrapper allocates (19.3 MB at bs 32,
// 3 x 224 x 224: it stays in the 50 MB L2):
//
//   K3  W = (X P)^T;           out = (W P)^T                      = P X P
//   K1  W = (N P)^T;           u = x + noise_rate * ((W P)^T + shift)   (written)
//       out = B clip(u, -1, 1) B^T                           (one blur pass)
//   K2  g_u = (B^T g B) * 1{-1 <= u <= 1}               (g_x; one adjoint pass)
//       W = (g_u P)^T;         g_n = noise_rate * (W P)^T
//
// P Y P is the masked low-pass D^T((D y D^T) o M)D once the DC passes the
// mask (c >= 1), and the affine pre- and post-scaling of the JAX kernels
// folds away; at c = 0, P = 0 and K1's shift is -1 (low = -1).
//
// The products.  P is exactly symmetric (the wrapper builds it so), so
// P Z = ((Z^T) P)^T: both products of a chain are one kernel, "the batch's
// stacked rows (planes * H of them) times the shared P", that stores each
// plane's output transposed.  The first stores W_b = (A_b P)^T, the second
// reads W as its rows and stores (W_b P)^T = P A_b P in the plane's own
// layout, through the epilogue alpha * (acc + shift) (+ addend) that gives
// K1's u and K2's g_n.  Both operands are K-major: rows of A, and rows of P
// standing in for its columns.
//
// What bounds them: 2 H^3 FMA a plane, 4.32 GFLOP at 224 px and 96 planes,
// 0.064 ms in float32 FMA (67 TFLOP/s), where cuBLAS's f32 chain takes
// ~0.14 ms.  The design:
//   1. runs on the tensor cores (mma.sync m16n8k8 TF32) in three passes:
//      each operand is split as big = tf32(v), small = tf32(v - big)
//      (cvt.rna), and small*big + big*small + big*big is accumulated in
//      float32, the small terms in their own sums: the tensor core truncates
//      as it accumulates, and one sum for all three passes erred 1.8e-5 on
//      K3 at 224 px against 7e-6 with two (one TF32 pass errs ~1e-3, ten
//      times the port's 1e-4 tolerance).  So the least time is 3 x 4.32
//      GFLOP at 495 TFLOP/s of TF32, 0.026 ms;
//   2. keeps P in shared memory: P arrives split once, in the order the B
//      fragments read it (one 8-byte load each for big and small), and a
//      persistent block, one an SM, holds its 56 columns' rows of P (102 KB
//      at 224 px) while it walks its row tiles; only A streams through the
//      ring (3 slices of 32, cp.async), across tile boundaries;
//   3. tiles that divide 224: 224 stacked rows x 56 columns (at 224 px a
//      tile is one plane, 224 = 4 x 56; no FMA on padding), seven warps of
//      32 x 56, each thread 112 accumulators (no spills), A split in
//      registers by the one warp that reads it.  224 rows also balance the
//      persistent grid: 96 planes x 4 column tiles over 132 blocks is 2.91
//      tiles a block for 3 tile-times, where 256-row tiles gave 84 x 4 tiles
//      and 2.55 for 3.  Rows are padded so every fragment load of a warp is
//      free of bank conflicts.  16-byte copies where A's rows are 16-byte
//      aligned (H % 4 == 0), 4-byte ones otherwise; what lies past an edge
//      is zero-filled (source size 0).
// Any H > 64 works by masking: past H the loads are zero and the stores
// skipped; above 224 px P's depth comes in windows.  Measured on an H100
// (PERF.md): ~62 us a product at 224 px, 96 planes, ~21% of the 3xTF32
// bound and ~32% of the rate at which the card issues mma.sync m16n8k8
// TF32 with no loads (scripts/mma_tf32_rate.py): 7 warps an SM (the
// accumulators' registers) leave the tensor pipe waiting on the fragments'
// loads and splits, so a round of tiles takes about as long with 7 warps as
// with 8, and the better balance of 224-row tiles gained ~2%.  wgmma, which
// reads B from shared memory itself and needs no such registers, is the
// next step.  The mma and the TF32 rounding sit behind mma_tf32 and
// to_tf32, and the copies behind copy_async/commit_async/wait_async, so
// that a host build of this header can stand in for them
// (COMBAT_PTX_EMULATED).
//
// The blur.  B is the reflect-padded k-tap blur of ops/blur.py::blur_matrix,
// B[m][s] = sum_t taps[t] [refl(m + t - p) == s], p = k / 2.  K1's
// B clip(u) B^T is one kernel (blur_kernel): a block owns a 56 x 32 output
// tile, copies u's block with its k / 2 halo into shared memory once
// (clipped on load, reflect indices at the plane's edges), runs the column
// band R = clip(u) B^T into a second buffer and the row band from there
// straight to out.  u is read once, out written once; R never reaches
// device memory.  The taps are taken in chunks of 8 each way, so any k with
// k / 2 < H fits in 18 KB of shared memory (the CLIs use k = 3).  K2's
// (B^T g B) * 1{-1 <= u <= 1} is one kernel of the same shape
// (adjoint_kernel).  B^T is not the flipped stencil at the reflect borders:
// along one axis
//   (B^T s)[q] = sum_t taps[t] (s[q + p - t]
//                 + [q > 0] s[p - t - q] + [q < H-1] s[2(H-1) + p - t - q])
// each term only where its index lies in [0, H): the three ways refl can
// land on q.  So a tile stages up to three windows of the zero-padded
// source a tap chunk each way, the direct one and, near the plane's edges,
// the two mirrored ones (read backwards), with no reflected indices; the
// mask's u is read once and g_x written once, so the pass moves 3 planes
// (57.8 MB at 224 px, bs 32: 17.3 us at 3.35 TB/s).
//
// Bytes at 224 px, bs 32: K1/K2 move 77.1 MB (0.023 ms at 3.35 TB/s), K3
// 38.5 MB; so all three are bound by the tensor cores' operations.

#include <cstdint>

namespace tiled {

// ---------------------------------------------------------------------------
// PTX primitives (a host emulation defines COMBAT_PTX_EMULATED and its own)
// ---------------------------------------------------------------------------

#ifndef COMBAT_PTX_EMULATED
// v rounded to TF32 (10 mantissa bits), to nearest with ties away from zero.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// c += a b for one warp's 16 x 8 x 8 TF32 tile.  Fragments (g = lane / 4,
// t = lane % 4): a = A(g, t), A(g+8, t), A(g, t+4), A(g+8, t+4);
// b = B(t, g), B(t+4, g); c = C(g, 2t), C(g, 2t+1), C(g+8, 2t), C(g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy Bytes (16 or 4) from src to shared dst, or zero-fill dst where !valid.
template <int Bytes>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? Bytes : 0;
  if (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void commit_async() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_async() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
#endif  // COMBAT_PTX_EMULATED

// ---------------------------------------------------------------------------
// The products: C = alpha * ((A P)^T per plane + shift) (+ addend)
// ---------------------------------------------------------------------------

constexpr int kMT = 2;             // a warp's rows: 2 mma tiles of 16
constexpr int kProductWarps = 7;
constexpr int kBM = kProductWarps * 16 * kMT;  // stacked rows of a tile: 224
constexpr int kBN = 56;            // columns of a tile (224 = 4 x 56)
constexpr int kBK = 32;            // depth of a K slice of A
constexpr int kStages = 3;         // A's slices in the cp.async ring
constexpr int kWindow = 224;       // depth of P a block holds (H <= 224 in one piece)
constexpr int kLdA = kBK + 4;           // A's row stride (floats): conflict-free fragment loads
constexpr int kLdP = 2 * kWindow + 8;   // P's row stride (floats): conflict-free 8-byte fragment loads
constexpr int kProductThreads = 32 * kProductWarps;  // each warp 16 kMT rows x 56 columns (kMT x 7 mma tiles)
constexpr int kNT = kBN / 8;
constexpr size_t kProductSmem =
    (static_cast<size_t>(kBN) * kLdP + static_cast<size_t>(kStages) * kBM * kLdA) * sizeof(float);  // 198,912 B
static_assert((kProductThreads / 32) * 16 * kMT == kBM, "warps tile the rows");

__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// Start copying rows [row0, row0 + Rows) x floats [f0, f0 + Floats) of a
// row-major matrix of `rows` rows and `cols` floats a row into dst (row
// stride Ld floats); what lies past either edge is zero-filled.  `vec`:
// 16-byte copies (rows and f0 16-byte aligned, cols % 4 == 0).
template <int Rows, int Floats, int Ld>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, long long row0, long long rows,
                                          int cols, int f0, bool vec) {
  if (vec) {
    constexpr int kPerRow = Floats / 4, kChunks = Rows * kPerRow;
#pragma unroll 4
    for (int c = threadIdx.x; c < kChunks; c += kProductThreads) {
      const int r = c / kPerRow, f = (c % kPerRow) * 4;
      const long long gr = row0 + r;
      const bool ok = gr < rows && f0 + f < cols;
      copy_async<16>(dst + r * Ld + f, ok ? src + gr * cols + f0 + f : src, ok);
    }
  } else {
    constexpr int kElems = Rows * Floats;
    for (int c = threadIdx.x; c < kElems; c += kProductThreads) {
      const int r = c / Floats, f = c % Floats;
      const long long gr = row0 + r;
      const bool ok = gr < rows && f0 + f < cols;
      copy_async<4>(dst + r * Ld + f, ok ? src + gr * cols + f0 + f : src, ok);
    }
  }
}

// For the `rows` = planes * H stacked rows of A (plane b's row i is row
// b * H + i) and the symmetric H x H projector P: Y = A P, stored per plane
// transposed, C[b][j][i] = alpha * (Y[b * H + i][j] + shift) +
// addend[b][j][i].  `vec`: A's rows are 16-byte aligned (H % 4 == 0, an
// aligned base).
//
// P comes split and in fragment order (the wrapper's _projector_split):
// row n holds, for each 8-deep block of k, big(t), big(t+4) for t = 0..3,
// then small(t), small(t+4), with the depth padded to Kp = 8 ceil(H / 8);
// so a lane's B fragment, (k = t, n), (k = t + 4, n), is one 8-byte load.
//
// Persistent blocks: block b owns the columns [56 (b % tiles_n), + 56) and
// walks the row tiles b / tiles_n, + per_n, ...  Its 56 rows of P stay in
// shared memory (102 KB at 224 px), so only A streams through the ring,
// across tile boundaries.  Above 224 px P's depth comes in windows of 224,
// reloaded where the window changes.
__global__ void __launch_bounds__(kProductThreads, 1)
    product_kernel(const float* __restrict__ A, const float* __restrict__ Ps, float* __restrict__ C,
                   const float* __restrict__ addend, long long rows, int H, int tiles_n, int per_n, float alpha,
                   float shift, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + kBN * kLdP;  // [kStages][kBM][kLdA], after P's rows [kBN][kLdP]
  const int col0 = (blockIdx.x % tiles_n) * kBN, kp = (H + 7) / 8 * 8;
  const long long first = blockIdx.x / tiles_n, tiles_m = (rows + kBM - 1) / kBM;
  const int my_tiles = first < tiles_m ? static_cast<int>((tiles_m - first + per_n - 1) / per_n) : 0;
  const int slices = (H + kBK - 1) / kBK, per_window = kWindow / kBK;
  const int total = my_tiles * slices;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  auto tile_row0 = [&](int f) { return (first + static_cast<long long>(f / slices) * per_n) * kBM; };
  auto load_a = [&](int f) {
    load_rows<kBM, kBK, kLdA>(ring + (f % kStages) * kBM * kLdA, A, tile_row0(f), rows, H, (f % slices) * kBK, vec);
  };
  auto load_p = [&](int window) {
    load_rows<kBN, 2 * kWindow, kLdP>(smem, Ps, col0, H, 2 * kp, 2 * kWindow * window, true);
  };
  // big.big and the two small terms in separate sums: the tensor core
  // truncates as it accumulates, so each sum loses ~1 ulp of its own size
  // an mma, and the small terms' sum is ~2^-11 of the big one's.
  float big[kMT][kNT][4], small[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[mi][ni][e] = small[mi][ni][e] = 0.f;

  load_p(0);
  commit_async();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_a(s);
    commit_async();
  }
  int resident = 0;
  for (int f = 0; f < total; ++f) {
    const int ks = f % slices, window = ks / per_window;
    if (window != resident) {  // only above kWindow
      __syncthreads();         // everyone is done with the old window
      load_p(window);
      commit_async();
      wait_async<0>();
      resident = window;
    }
    wait_async<kStages - 2>();  // this thread's copies of slice f (and of P) have landed
    __syncthreads();            // everyone's have, and everyone is done with slice f - 1's stage
    if (f + kStages - 1 < total) load_a(f + kStages - 1);
    commit_async();
    const float* As = ring + (f % kStages) * kBM * kLdA + (warp * 16 * kMT + g) * kLdA + t;
    const float* Bs = smem + g * kLdP + (ks - window * per_window) * kBK * 2 + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ab[kMT][4], as[kMT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const float* a = As + mi * 16 * kLdA + kk;
        split_tf32(a[0], ab[mi][0], as[mi][0]);             // (g, t)
        split_tf32(a[8 * kLdA], ab[mi][1], as[mi][1]);      // (g + 8, t)
        split_tf32(a[4], ab[mi][2], as[mi][2]);             // (g, t + 4)
        split_tf32(a[8 * kLdA + 4], ab[mi][3], as[mi][3]);  // (g + 8, t + 4)
      }
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        // P's row n = column n of the K x N operand: (k = t, n = g), (k = t + 4, n = g)
        const float2 fb = *reinterpret_cast<const float2*>(Bs + ni * 8 * kLdP + 2 * kk);
        const float2 fs = *reinterpret_cast<const float2*>(Bs + ni * 8 * kLdP + 2 * kk + 8);
        const uint32_t bb[2] = {__float_as_uint(fb.x), __float_as_uint(fb.y)};
        const uint32_t bs[2] = {__float_as_uint(fs.x), __float_as_uint(fs.y)};
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          mma_tf32(small[mi][ni], as[mi], bb);
          mma_tf32(small[mi][ni], ab[mi], bs);
          mma_tf32(big[mi][ni], ab[mi], bb);
        }
      }
    }
    if (ks != slices - 1) continue;

    // The tile is done: row r = b * H + i, column j goes to C[b][j][i].  The
    // 8 lanes of one t write 8 consecutive i (whole 32-byte sectors); the
    // addend is read into `small` in one sweep before any store.
    const size_t n = static_cast<size_t>(H) * H;
    long long base[kMT][2];  // C's offset of (row, column 0), or -1 past the last row
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = tile_row0(f) + (warp * kMT + mi) * 16 + g + 8 * h, b = r / H;
        base[mi][h] = r < rows ? b * static_cast<long long>(n) + (r - b * H) : -1;
      }
    auto index = [&](int mi, int ni, int e) {  // C's index of fragment value e of mma tile (mi, ni); -1 outside
      const int j = col0 + ni * 8 + 2 * t + (e & 1);
      const long long row = base[mi][e >> 1];
      return row >= 0 && j < H ? row + static_cast<long long>(j) * H : -1LL;
    };
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          big[mi][ni][e] = alpha * (big[mi][ni][e] + small[mi][ni][e] + shift);
          const long long idx = index(mi, ni, e);
          small[mi][ni][e] = addend != nullptr && idx >= 0 ? __ldg(addend + idx) : 0.f;
        }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long idx = index(mi, ni, e);
          if (idx >= 0) C[idx] = big[mi][ni][e] + small[mi][ni][e];
          big[mi][ni][e] = small[mi][ni][e] = 0.f;
        }
  }
}

// ---------------------------------------------------------------------------
// The blur
// ---------------------------------------------------------------------------

constexpr int kBlurCols = 32;   // output tile: 32 columns (a warp's lanes) ...
constexpr int kBlurRows = 56;   // ... by 56 rows, 7 a warp (224 = 4 x 56)
constexpr int kTapChunk = 8;    // taps per pass over the staged block
constexpr int kBlurThreads = 256;
constexpr int kBlurWarps = kBlurThreads / 32;
constexpr int kStagedPerWarp = (kBlurRows + kTapChunk - 1 + kBlurWarps - 1) / kBlurWarps;  // 8
constexpr int kStagedRows = kStagedPerWarp * kBlurWarps;                                   // 64
constexpr int kStagedCols = kBlurCols + kTapChunk - 1;                                     // 39
constexpr int kColsPerLane = (kStagedCols + 31) / 32;                                      // 2

__device__ __forceinline__ int reflect(int r, int H) {
  r = abs(r);
  return r > H - 1 ? 2 * (H - 1) - r : r;
}

// out = B clip(u, -1, 1) B^T for every plane; a block owns one 56 x 32
// output tile (tiles_i x tiles_j a plane).  With p = k / 2, for the row taps
// [t0, t0 + nt) it stages R[s][jj] = sum_c taps[c] clip(u)[refl(i0 + t0 - p + s)]
// [refl(j0 + jj + c - p)], the column band of the rows those taps reach,
// from u's block U[s][w] = clip(u)[refl(i0 + t0 - p + s)][refl(j0 + c0 - p + w)],
// copied into shared memory once per column-tap chunk [c0, c0 + nc).  Then
// out[i0 + ii][j0 + jj] += sum_t taps[t] R[ii + t - t0][jj].  With k <= 8
// (the CLIs use 3) that is one chunk each way.  Each phase runs its rows
// as unrolled, independent loads and FMAs, so a thread has all of its
// loads in flight at once.  Columns past the plane's edge are clamped onto
// valid indices for the loads and never stored.
__global__ void __launch_bounds__(kBlurThreads) blur_kernel(const float* __restrict__ u, float* __restrict__ out,
                                                            const float* __restrict__ taps, int H, int k,
                                                            int tiles_i, int tiles_j) {
  __shared__ float U[kStagedRows][kStagedCols];
  __shared__ float R[kStagedRows][kBlurCols];
  const int per_plane = tiles_i * tiles_j;
  const size_t plane = blockIdx.x / per_plane, n = static_cast<size_t>(H) * H;
  const int tile = blockIdx.x % per_plane;
  const int i0 = (tile / tiles_j) * kBlurRows, j0 = (tile % tiles_j) * kBlurCols;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, p = k / 2;
  const int rows_out = min(kBlurRows, H - i0);
  const float* src = u + plane * n;
  constexpr int kRowsPerWarp = kBlurRows / kBlurWarps;
  float acc[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = 0.f;

  for (int t0 = 0; t0 < k; t0 += kTapChunk) {
    const int nt = min(kTapChunk, k - t0), staged = rows_out + nt - 1;
    float r[kStagedPerWarp];  // this lane's column of R, rows warp + 8 q
#pragma unroll
    for (int q = 0; q < kStagedPerWarp; ++q) r[q] = 0.f;
    for (int c0 = 0; c0 < k; c0 += kTapChunk) {
      const int nc = min(kTapChunk, k - c0), width = kBlurCols + nc - 1;
      float v[kStagedPerWarp][kColsPerLane];
#pragma unroll
      for (int q = 0; q < kStagedPerWarp; ++q) {
        const int s = warp + q * kBlurWarps;
        const float* row = src + static_cast<size_t>(reflect(min(i0 + t0 - p + s, 2 * (H - 1)), H)) * H;
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          const int w = lane + 32 * c;
          v[q][c] = s < staged && w < width ? __ldg(row + reflect(min(j0 + c0 - p + w, 2 * (H - 1)), H)) : 0.f;
        }
      }
      __syncthreads();  // U is free
#pragma unroll
      for (int q = 0; q < kStagedPerWarp; ++q)
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c)
          if (lane + 32 * c < kStagedCols) U[warp + q * kBlurWarps][lane + 32 * c] = fminf(fmaxf(v[q][c], -1.f), 1.f);
      __syncthreads();
      for (int c = 0; c < nc; ++c) {
        const float w = __ldg(taps + c0 + c);
#pragma unroll
        for (int q = 0; q < kStagedPerWarp; ++q) r[q] = fmaf(w, U[warp + q * kBlurWarps][lane + c], r[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kStagedPerWarp; ++q) R[warp + q * kBlurWarps][lane] = r[q];
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float w = __ldg(taps + t0 + t);
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = fmaf(w, R[warp + q * kBlurWarps + t][lane], acc[q]);
    }
    __syncthreads();  // R is free
  }
  const int j = j0 + lane;
  if (j >= H) return;
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int ii = warp + q * kBlurWarps;
    if (ii < rows_out) out[plane * n + static_cast<size_t>(i0 + ii) * H + j] = acc[q];
  }
}

// Where one side of the adjoint's fold reads, along one axis, for the
// outputs [q0, q0 + n) and the taps [t0, t0 + nt), p = k / 2: staged index
// w (0 <= w < n + nt - 1) holds the source at first + w (the direct side) or
// first - w (the mirrored ones).  Output q0 + o takes tap t0 + c times staged
// w = o + c, the direct side's taps reversed (tap t0 + nt - 1 - c):
//   direct  s[q + p - t]                   first = q0 + p - t0 - nt + 1
//   near    s[p - t - q],         q > 0      first = p - t0 - q0
//   far     s[2(H-1) + p - t - q], q < H-1   first = 2(H-1) + p - t0 - q0
// (the three e with refl(e) = q, e = m + t - p for the source m).
constexpr int kSides = 3;

__device__ __forceinline__ int side_first(int side, int q0, int t0, int nt, int p, int H) {
  return side == 0 ? q0 + p - t0 - nt + 1 : side == 1 ? p - t0 - q0 : 2 * (H - 1) + p - t0 - q0;
}

// What one side does for a tap chunk: nothing (none of its `count` staged
// sources lies in [0, H)), or its own pass, or, for a mirrored side whose
// sources in the plane all lie in the direct side's window, a read of that
// window in the direct pass (fold): at k <= 8 every mirrored side folds.
enum SideWork { kNone, kPass, kFold };

__device__ __forceinline__ SideWork side_work(int side, int first, int direct_first, int count, int H) {
  const int lo = max(side == 0 ? first : first - (count - 1), 0);
  const int hi = min(side == 0 ? first + count - 1 : first, H - 1);
  if (lo > hi) return kNone;
  return side != 0 && lo >= direct_first && hi < direct_first + count ? kFold : kPass;
}

// Whether output q takes the side at all: q = 0 and q = H - 1 count their own
// term once.
__device__ __forceinline__ bool side_takes(int side, int q, int H) {
  return side == 0 || (side == 1 ? q > 0 : q < H - 1);
}

// K2's g_x = g_u = (B^T g B) * 1{-1 <= u <= 1} for every plane, in one pass;
// a block owns one 56 x 32 output tile as blur_kernel does.  Along each axis
// B^T folds three windows onto the outputs (side_first): for the row taps
// [t0, t0 + nt) and each row side with a pass, it stages R, the column
// adjoint of that side's rows, summed over the column taps' chunks and
// sides from g's blocks copied into shared memory once each (zeros outside
// the plane, no reflected indices); then the row pass adds R's taps to the
// outputs that take the side.  A mirrored side that folds is read from the
// direct side's buffer in the direct pass, backwards, so at k <= 8 every
// tile runs one pass, as blur_kernel does; the edge tiles add the mirrored
// reads.  (With every mirrored side a pass of its own, 2 passes an edge tile
// and 4 a corner, the pass took 46.0 us at 224 px and 96 planes on an H100,
// at the same four blocks an SM, against 40.1 with the folds; PERF.md.)
// u is read once for the mask, g_x written once; R never reaches device
// memory.  Any k with k / 2 < H.
//
// Four blocks an SM, so 64 registers a thread: left to itself nvcc gives
// the pass 128 registers and two blocks an SM, and it took 57.9 us at 224
// px and 96 planes on an H100 against 39.7; three blocks (80 registers)
// took 51.4 us, five (48, spilling) 71.3 (PERF.md).  Copying g's block or
// u's tile with cp.async in place of registers did not help (41-49 us).
constexpr int kAdjointBlocksPerSM = 4;

__global__ void __launch_bounds__(kBlurThreads, kAdjointBlocksPerSM)
    adjoint_kernel(const float* __restrict__ g, const float* __restrict__ u, float* __restrict__ gx,
                   const float* __restrict__ taps, int H, int k, int tiles_i, int tiles_j) {
  __shared__ float S[kStagedRows][kStagedCols];
  __shared__ float R[kStagedRows][kBlurCols];
  const int per_plane = tiles_i * tiles_j;
  const size_t plane = blockIdx.x / per_plane, n = static_cast<size_t>(H) * H;
  const int tile = blockIdx.x % per_plane;
  const int i0 = (tile / tiles_j) * kBlurRows, j0 = (tile % tiles_j) * kBlurCols;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, p = k / 2;
  const int rows_out = min(kBlurRows, H - i0), j = j0 + lane;
  const float* src = g + plane * n;
  constexpr int kRowsPerWarp = kBlurRows / kBlurWarps;
  float acc[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = 0.f;

  for (int t0 = 0; t0 < k; t0 += kTapChunk) {
    const int nt = min(kTapChunk, k - t0), staged = rows_out + nt - 1;
    const int rd = side_first(0, i0, t0, nt, p, H);
    for (int si = 0; si < kSides; ++si) {
      const int ri = side_first(si, i0, t0, nt, p, H), di = si == 0 ? 1 : -1;
      if (side_work(si, ri, rd, staged, H) != kPass) continue;
      float r[kStagedPerWarp];  // this lane's column of R, rows warp + 8 q
#pragma unroll
      for (int q = 0; q < kStagedPerWarp; ++q) r[q] = 0.f;
      for (int c0 = 0; c0 < k; c0 += kTapChunk) {
        const int nc = min(kTapChunk, k - c0), width = kBlurCols + nc - 1;
        const int cd = side_first(0, j0, c0, nc, p, H);
        for (int sj = 0; sj < kSides; ++sj) {
          const int cj = side_first(sj, j0, c0, nc, p, H), dj = sj == 0 ? 1 : -1;
          if (side_work(sj, cj, cd, width, H) != kPass) continue;
          float v[kStagedPerWarp][kColsPerLane];
#pragma unroll
          for (int q = 0; q < kStagedPerWarp; ++q) {
            const int s = warp + q * kBlurWarps, row = ri + di * s;
            const bool row_ok = s < staged && row >= 0 && row < H;
#pragma unroll
            for (int c = 0; c < kColsPerLane; ++c) {
              const int w = lane + 32 * c, col = cj + dj * w;
              v[q][c] = row_ok && w < width && col >= 0 && col < H ? __ldg(src + static_cast<size_t>(row) * H + col)
                                                                   : 0.f;
            }
          }
          __syncthreads();  // S is free
#pragma unroll
          for (int q = 0; q < kStagedPerWarp; ++q)
#pragma unroll
            for (int c = 0; c < kColsPerLane; ++c)
              if (lane + 32 * c < kStagedCols) S[warp + q * kBlurWarps][lane + 32 * c] = v[q][c];
          __syncthreads();
          const bool takes = side_takes(sj, j, H);
          for (int c = 0; c < nc; ++c) {
            const float w = takes ? __ldg(taps + c0 + (sj == 0 ? nc - 1 - c : c)) : 0.f;
#pragma unroll
            for (int q = 0; q < kStagedPerWarp; ++q) r[q] = fmaf(w, S[warp + q * kBlurWarps][lane + c], r[q]);
          }
          if (sj != 0) continue;
          for (int mj = 1; mj < kSides; ++mj) {  // the mirrored sides that fold into this window, backwards
            const int first = side_first(mj, j0, c0, nc, p, H);
            if (side_work(mj, first, cd, width, H) != kFold) continue;
            const bool takes_m = side_takes(mj, j, H);
            for (int c = 0; c < nc; ++c) {
              const int idx = first - cd - lane - c;
              const float w = takes_m && idx >= 0 && idx < width ? __ldg(taps + c0 + c) : 0.f;
              const int at = min(max(idx, 0), kStagedCols - 1);
#pragma unroll
              for (int q = 0; q < kStagedPerWarp; ++q) r[q] = fmaf(w, S[warp + q * kBlurWarps][at], r[q]);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kStagedPerWarp; ++q) R[warp + q * kBlurWarps][lane] = r[q];
      __syncthreads();
      for (int t = 0; t < nt; ++t) {
        const float w = __ldg(taps + t0 + (si == 0 ? nt - 1 - t : t));
#pragma unroll
        for (int q = 0; q < kRowsPerWarp; ++q) {
          const int ii = warp + q * kBlurWarps;
          if (side_takes(si, i0 + ii, H)) acc[q] = fmaf(w, R[ii + t][lane], acc[q]);
        }
      }
      for (int mi = 1; si == 0 && mi < kSides; ++mi) {  // the mirrored sides that fold into R, backwards
        const int first = side_first(mi, i0, t0, nt, p, H);
        if (side_work(mi, first, rd, staged, H) != kFold) continue;
        for (int t = 0; t < nt; ++t) {
          const float w = __ldg(taps + t0 + t);
#pragma unroll
          for (int q = 0; q < kRowsPerWarp; ++q) {
            const int ii = warp + q * kBlurWarps, idx = first - rd - ii - t;
            if (idx >= 0 && idx < staged && side_takes(mi, i0 + ii, H)) acc[q] = fmaf(w, R[idx][lane], acc[q]);
          }
        }
      }
      __syncthreads();  // R is free
    }
  }
  if (j >= H) return;
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int ii = warp + q * kBlurWarps;
    if (ii >= rows_out) continue;
    const size_t at = plane * n + static_cast<size_t>(i0 + ii) * H + j;
    const float m = __ldg(u + at);
    gx[at] = m >= -1.f && m <= 1.f ? acc[q] : 0.f;
  }
}

}  // namespace tiled
