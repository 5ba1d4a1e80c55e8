// LayerNorm folded into bias-free matmuls for Hopper (sm_90a), bf16.
//
// Replaces gill_tpu/ops/ln_matmul.py `ln_matmul` (Pallas `_kernel`) and
// `ln_matmul_stacked` (`_kernel_stacked`): out[k] = LN(x) . W[k] for
// k < K (K = 1: the cross-attention q projection; K = 3: the
// self-attention q, k and v), x (M, d), W (K, d, n), out (K, M, n)
// contiguous, so q, k and v are free leading-axis views. The LayerNorm
// keeps `_ln_rows`' rounding points (common.cuh `ln_rows_inplace`).
//
// What bounds it on an H100: 2 K d n FLOPs a row on the bf16 tensor cores
// against 2 (d + K n) bytes a row; at the UNet's d = 320 / 640 (n = d) that
// is ~100-200 FLOPs a byte, under the card's ~295, so it sits near the
// memory roof. Unfused, the normalized (M, d) tensor makes one extra round
// trip through device memory before the projections read it. Design:
//  * one block = BM = 64 rows x BN = 64 output columns, 8 warps; the
//    (64, d) x tile is copied into shared memory once (cp.async), the
//    LayerNorm runs on it in place (one warp a row), and the normalized
//    tile is multiplied by the (d, 64) column panel of each of the K
//    weights in turn (WMMA bf16 16x16x16, fp32 sums, one rounding to
//    bf16), so x is read once for all K projections of its columns;
//  * a weight panel is one cp.async copy of d x 64 bf16 (40 / 80 KB); the
//    first overlaps the x tile's copy and the LayerNorm;
//  * each warp owns one 16-row slab and two 16-column fragments.
// Double-buffered weight panels, TMA and wgmma are later work.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int NT = 256;          // 8 warps
constexpr int NW = NT / 32;
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int PAD = 8;           // bf16 row padding (16 bytes)
constexpr int LW = BN + PAD;     // weight panel row stride
constexpr int LC = BN + 4;       // fp32 output staging row stride

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <int D> struct LSmem {
  static constexpr int LX = D + PAD;
  static constexpr size_t xs = 0;
  static constexpr size_t ws = xs + align128(sizeof(bf16) * BM * LX);
  static constexpr size_t cs = ws + align128(sizeof(bf16) * D * LW);
  static constexpr size_t total = cs + sizeof(float) * BM * LC;
};

template <int D>
__global__ void __launch_bounds__(NT)
    ln_matmul_fwd(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                  const bf16* __restrict__ beta, const bf16* __restrict__ w,
                  bf16* __restrict__ out, int M, int n, int K, float eps) {
  using S = LSmem<D>;
  constexpr int LX = S::LX;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + S::xs);    // [BM][LX]
  bf16* wsm = reinterpret_cast<bf16*>(smem + S::ws);   // [D][LW]
  float* cs = reinterpret_cast<float*>(smem + S::cs);  // [BM][LC]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // the d x 64 column panel of weight k
  auto load_panel = [&](int k) {
    const bf16* src = w + (long long)k * D * n + n0;
    for (int i = tid; i < D * (BN / 8); i += NT) {
      const int r = i / (BN / 8), q = i % (BN / 8);
      cp_async16(wsm + r * LW + q * 8, src + (long long)r * n + q * 8);
    }
  };

  // x rows m0..m0+BM (zeros past M), then weight 0's panel, one group
  for (int i = tid; i < BM * (D / 8); i += NT) {
    const int r = i / (D / 8), q = i % (D / 8);
    if (m0 + r < M)
      cp_async16(xs + r * LX + q * 8, x + (long long)(m0 + r) * D + q * 8);
    else
      *reinterpret_cast<uint4*>(xs + r * LX + q * 8) = make_uint4(0, 0, 0, 0);
  }
  load_panel(0);
  cp_async_commit();
  cp_async_wait_prior<0>();
  __syncthreads();
  ln_rows_inplace<D>(xs, LX, BM, gamma, beta, eps, warp, NW, lane);
  __syncthreads();

  const int rf = warp % 4;             // this warp's 16-row slab
  const int cf0 = (warp / 4) * 2;      // and its two 16-column fragments
  for (int k = 0; k < K; ++k) {
    if (k > 0) {
      __syncthreads();                 // every warp is done with panel k-1
      load_panel(k);
      cp_async_commit();
      cp_async_wait_prior<0>();
      __syncthreads();
    }
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, xs + rf * 16 * LX + kk, LX);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, wsm + kk * LW + (cf0 + j) * 16, LW);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    // each warp stages and writes only its own 16 x 32 region
    float* my = cs + rf * 16 * LC + cf0 * 16;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(my + j * 16, acc[j], LC, wmma::mem_row_major);
    __syncwarp();
    bf16* dst = out + ((long long)k * M + m0 + rf * 16) * n + n0 + cf0 * 16;
    for (int e = lane; e < 16 * 32; e += 32) {
      const int r = e / 32, c = e % 32;
      if (m0 + rf * 16 + r < M)
        dst[(long long)r * n + c] = __float2bfloat16(my[r * LC + c]);
    }
    __syncwarp();
  }
}

template <int D>
cudaError_t launch(const void* x, const void* gamma, const void* beta,
                   const void* w, void* out, int M, int n, int K, float eps,
                   cudaStream_t stream) {
  constexpr size_t smem = LSmem<D>::total;
  cudaError_t e = cudaFuncSetAttribute(
      ln_matmul_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((M + BM - 1) / BM, n / BN);
  ln_matmul_fwd<D><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), M, n, K, eps);
  return cudaGetLastError();
}

}  // namespace

// All tensors bf16 and contiguous with 16-byte aligned bases: x (M, d),
// gamma and beta (d), w (K, d, n), out (K, M, n); d in {320, 640}, n a
// multiple of 64, 1 <= K <= 3. Returns a cudaError_t (0 = launched).
extern "C" int gill_ln_matmul(const void* x, const void* gamma,
                              const void* beta, const void* w, void* out,
                              int M, int d, int n, int K, float eps,
                              void* stream) {
  if (M <= 0 || n <= 0 || n % BN || K < 1 || K > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 320: return (int)launch<320>(x, gamma, beta, w, out, M, n, K, eps, st);
    case 640: return (int)launch<640>(x, gamma, beta, w, out, M, n, K, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
