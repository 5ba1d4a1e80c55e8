// LayerNorm folded into bias-free matmuls for Hopper (sm_90a), bf16.
//
// Replaces gill_tpu/ops/ln_matmul.py `ln_matmul` (Pallas `_kernel`) and
// `ln_matmul_stacked` (`_kernel_stacked`): out[k] = LN(x) . W[k] for
// k < K (K = 1: the cross-attention q projection; K = 3: the
// self-attention q, k and v), x (M, d), W (K, d, n), out (K, M, n)
// contiguous, so q, k and v are free leading-axis views. The LayerNorm
// keeps `_ln_rows`' rounding points (wg_gemm.cuh `ln_row_stats`,
// `ln_apply8`).
//
// What bounds it on an H100: 2 K d n flops a row on the bf16 tensor cores
// against 2 (d + K n) bytes a row; at the UNet's d = 320 / 640 (n = d) that
// is ~100-200 flops a byte, under the card's ~295, so it sits near the
// memory roof: 1.8-6.4 us at the UNet's shapes. Unfused, the normalized
// (M, d) tensor makes one extra round trip through device memory before
// the projections read it. The design:
//  * `ln_stats` writes each row's fp32 (mean, inv), M x 8 bytes, reading x
//    once;
//  * `ln_matmul_wg` is K3's TMA-fed wgmma core (wg_gemm.cuh) with the
//    LayerNorm prologue: a block takes BM rows and NX of the K n / 64
//    weight boxes of 64 columns (the K weights side by side, box b of
//    weight b / (n / 64)); each stage's x tile is normalized in shared
//    memory while the tensor cores run the previous one, and the weight
//    boxes reach wgmma's register operand through ldmatrix.trans. The
//    epilogue rounds once to bf16 and stores through shared memory;
//  * the plan (`ops/ln_matmul.py` `ln_matmul_plan`, which `plan_for` must
//    equal, or the call is refused) takes the first of (BM, NX) = (128,
//    2), (64, 2), (128, 1), (64, 1) that makes at least one block an SM,
//    else (64, 1): two boxes a block normalize each x tile once for both
//    (with an odd box count the last block loads its last box twice and
//    stores it once), and 128 rows (m64n128k16) read each weight box half
//    as often as 64 (m64n64k16), but a block's depth loop is a chain of
//    d / 64 dependent steps, so an SM left without a block costs more;
//  * `ln_matmul_wg` starts as a programmatic dependent launch: its
//    barriers and first x and weight copies overlap `ln_stats`, and it
//    waits for the statistics before its first normalization.

#include "wg_gemm.cuh"

namespace {

struct Plan {
  int bm, nx, boxes, col_blocks, row_blocks;
};

// the launch for x (M, d), W (K, d, n) on a card with `sms` SMs; false
// where the kernel does not take the call
bool plan_for(int M, int d, int n, int K, int sms, Plan* p) {
  if (M < 1 || (d != 320 && d != 640) || n < 64 || n % 64 || K < 1 ||
      K > 3 || sms < 1)
    return false;
  const int boxes = K * n / 64;
  constexpr int tiles[4][2] = {{128, 2}, {64, 2}, {128, 1}, {64, 1}};
  for (const auto& tile : tiles) {
    const int bm = tile[0], nx = tile[1];
    const int rows = (M + bm - 1) / bm, cols = (boxes + nx - 1) / nx;
    *p = {bm, nx, boxes, cols, rows};
    if ((nx == 1 || boxes > 1) && rows * cols >= sms) return true;
  }
  return true;
}

// out[k] rows m0 + [0, BM) for the NX boxes of block column blockIdx.x;
// box b (< boxes) is columns 64 (b % (n / 64)) + [0, 64) of weight
// b / (n / 64), read through a map over the (K d, n) stacked weights
template <int NX, int BM>
__global__ void __launch_bounds__(128)
    ln_matmul_wg(const __grid_constant__ CUtensorMap xa,
                 const __grid_constant__ CUtensorMap wa, LnTile<BM> ln,
                 bf16* __restrict__ out, int M, int d, int n, int boxes) {
  constexpr int LO = 64 * NX + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.y * BM, per_k = n / 64;
  int col[NX], row[NX];
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    const int b = min(NX * (int)blockIdx.x + j, boxes - 1);
    col[j] = 64 * (b % per_k);
    row[j] = d * (b / per_k);
  }
  float acc[NX][BM / 2];
  LnTile<BM> local = ln;
  wg_gemm<NX, BM>(acc, smem, &xa, &wa, m0, col, row, 0, d / WG_BK, local);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  bf16* st = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int jt = 0; jt < NX; ++jt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = 64 * jt + 16 * warp + g + 8 * hh;
#pragma unroll
      for (int i = 0; i < BM / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          st[(8 * i + 2 * t4 + e) * LO + c] =
              __float2bfloat16(acc[jt][4 * i + 2 * hh + e]);
    }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    const int b = NX * blockIdx.x + j;
    if (b < boxes)
      store_tile<BM, 64, 128, LO>(st + 64 * j,
                                     out + (long long)(b / per_k) * M * n, n,
                                     m0, 64 * (b % per_k), M);
  }
}

template <int NX, int BM>
cudaError_t launch(const void* x, const CUtensorMap& wa, LnTile<BM> ln,
                   void* out, int M, int d, int n, const Plan& p,
                   cudaStream_t stream) {
  CUtensorMap xa;
  if (!tensor_map(&xa, x, M, d, BM)) return cudaErrorInvalidValue;
  constexpr int ring = WgSmem<NX, BM>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ln_matmul_wg<NX, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ring + LnTile<BM>::smem_bytes(640));
  if (attr != cudaSuccess) return attr;
  return launch_dependent(ln_matmul_wg<NX, BM>,
                          dim3(p.col_blocks, p.row_blocks), 128,
                          ring + LnTile<BM>::smem_bytes(d), stream, xa, wa,
                          ln, static_cast<bf16*>(out), M, d, n, p.boxes);
}

}  // namespace

// The plan for (M, d, n, K) on `sms` SMs into out[5] = (bm, nx, boxes,
// col_blocks, row_blocks); a cudaError_t (invalid value where the kernel
// does not take the call).
extern "C" int gill_ln_matmul_plan(int M, int d, int n, int K, int sms,
                                   int* out) {
  Plan p;
  if (!plan_for(M, d, n, K, sms, &p)) return (int)cudaErrorInvalidValue;
  out[0] = p.bm, out[1] = p.nx, out[2] = p.boxes, out[3] = p.col_blocks,
  out[4] = p.row_blocks;
  return 0;
}

// All tensors bf16 and contiguous with 16-byte aligned bases: x (M, d),
// gamma and beta (d), w (K, d, n), out (K, M, n); stats a float32 (M, 2)
// scratch; d in {320, 640}, n a multiple of 64, 1 <= K <= 3; bm and nx
// the plan's (`gill_ln_matmul_plan` on `sms` SMs). Two launches, `ln_stats`
// and `ln_matmul_wg`. Returns a cudaError_t (0 = launched).
extern "C" int gill_ln_matmul(const void* x, const void* gamma,
                              const void* beta, const void* w, void* out,
                              void* stats, int M, int d, int n, int K, int bm,
                              int nx, int sms, float eps, void* stream) {
  Plan p;
  if (!plan_for(M, d, n, K, sms, &p) || p.bm != bm || p.nx != nx)
    return (int)cudaErrorInvalidValue;
  if (!aligned16({x, gamma, beta, w, out, stats}))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap wa;
  if (!tensor_map(&wa, w, K * d, n, 64)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_ln_stats(x, stats, M, d, eps, st);
  if (e != cudaSuccess) return (int)e;
  const float2* sp = static_cast<const float2*>(stats);
  const bf16 *g = static_cast<const bf16*>(gamma),
             *b = static_cast<const bf16*>(beta);
  if (bm == 128)
    return (int)(nx == 2 ? launch<2>(x, wa, LnTile<128>{sp, g, b, M, d}, out,
                                     M, d, n, p, st)
                         : launch<1>(x, wa, LnTile<128>{sp, g, b, M, d}, out,
                                     M, d, n, p, st));
  return (int)(nx == 2 ? launch<2>(x, wa, LnTile<64>{sp, g, b, M, d}, out, M,
                                   d, n, p, st)
                       : launch<1>(x, wa, LnTile<64>{sp, g, b, M, d}, out, M,
                                   d, n, p, st));
}
