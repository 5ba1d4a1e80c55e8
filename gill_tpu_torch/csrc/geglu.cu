// GEGLU feed-forward for Hopper (sm_90a), bf16 in and out:
//   out = (gelu(x Wg + bg) * (x Wv + bv)) W2 + b2,
// w1 (d, 8d) packing [val | gate] column halves, w2 (4d, d), the EXACT erf
// gelu of the composed path (diffusers GEGLU; gill_tpu models/sd/unet.py
// `_geglu_ff`), not the Pallas kernels' tanh form (Mosaic lacks erf).
//
// K3 replaces gill_tpu/ops/geglu.py `geglu_ff` (Pallas body `_kernel`) as
// two GEMMs with fused epilogues, both on the TMA-fed wgmma core of
// wg_gemm.cuh:
//  * `geglu_up_wg`: h = bf16((x Wv + bv) * gelu(x Wg + bg)), an (M, 4d)
//    intermediate rounded to bf16 once, where the Pallas kernel rounds it
//    (`h.astype(x.dtype)`) before its second product;
//  * `geglu_down_wg`: out = bf16(h W2 + b2), fp32 sums, b2 added in fp32.
// What bounds it on an H100: 24 M d^2 flops on the bf16 tensor cores,
// 0.020 ms at 989 TFLOP/s for M d^2 = 8192 x 320^2, 2048 x 640^2 and
// 512 x 1280^2; at M 128, d 1280 the 39 MB of W1 and W2 (0.012 ms at
// 3.35 TB/s). The design:
//  * `geglu_up_wg` takes 64 columns of h by 128 rows a block, two products
//    (the val and the gate columns of the same 64 columns of h);
//    `geglu_down_wg` 64 or 128 output columns, one or two products. The
//    same GEMMs on mma.sync fed by per-thread 16-byte cp.async ran 1.5-2.8x
//    slower at the four UNet shapes (timed by chip_smoke.py, PERF.md);
//  * the epilogues run in registers (bias, erf gelu, gating, one bf16
//    rounding) and stage the tile in shared memory for 16-byte stores;
//  * where `geglu_down_wg`'s tiles are fewer than half the SMs (d 1280: 4
//    at M 512, 14 at M 128), its depth is split; the splits write fp32
//    partials that `geglu_reduce` sums in a fixed order with b2, so the
//    result is the same run to run (`ops/geglu.py` `geglu_plan`).
// The intermediate's round trip costs 2 M 4d bf16 bytes (42 MB at d 320,
// M 8192). Each call encodes its four tensor maps on the host.
//
// K9 replaces `_kernel_ln` (geglu_ff with ln_gamma/ln_beta,
// GILL_SD_FUSE_LN=1): x is the raw residual stream and the block's third
// LayerNorm is folded into the first GEMM. `ln_stats` writes each row's
// fp32 (mean, inv) (M x 8 bytes); `geglu_up_wg` with the LayerNorm
// prologue (`LnTile`), launched so that its set-up and first copies overlap
// `ln_stats`, normalizes each x tile in shared memory before its wgmma
// group reads it; then K3's `geglu_down_wg`
// (and `geglu_reduce`) as they are, at K3's plan. The normalized (M, d)
// tensor never exists in device memory; each up block renormalizes its
// tiles (4d / 64 column blocks re-read x from L2), which the ALUs do while
// the tensor cores run the previous tile.

#include "wg_gemm.cuh"

namespace {

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// h (M, 4d) = bf16((x Wv + bv) * gelu(x Wg + bg)) for 64 columns [n0, n0
// + 64) of h and 128 rows a block: acc[0] the val columns, acc[1] the gate
// columns; with Pro = LnTile<>, x is normalized on the way (K9)
template <class Pro>
__global__ void __launch_bounds__(128)
    geglu_up_wg(const __grid_constant__ CUtensorMap xa,
                const __grid_constant__ CUtensorMap wa,
                const bf16* __restrict__ b1, bf16* __restrict__ h, int M,
                int d, Pro pro) {
  constexpr int LO = 64 + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int inner = 4 * d, n0 = blockIdx.x * 64, m0 = blockIdx.y * WG_BM;
  float acc[2][64];
  const int col[2] = {n0, inner + n0}, row[2] = {0, 0};
  Pro local = pro;
  wg_gemm<2>(acc, smem, &xa, &wa, m0, col, row, 0, d / WG_BK, local);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  bf16* st = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int c = 16 * warp + g + 8 * hh;
    const float bv = __bfloat162float(b1[n0 + c]);
    const float bg = __bfloat162float(b1[inner + n0 + c]);
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 4 * i + 2 * hh + e, r = 8 * i + 2 * t4 + e;
        st[r * LO + c] = __float2bfloat16((acc[0][k] + bv) *
                                          gelu_erf(acc[1][k] + bg));
      }
  }
  __syncthreads();
  store_tile<WG_BM, 64, 128>(st, h, inner, m0, n0, M);
}

// out (M, d) = bf16(h W2 + b2), 64 NX columns and 128 rows a block, over
// the depth tiles of split blockIdx.z; with more than one split the fp32
// partial goes to ws[split] and `geglu_reduce` finishes
template <int NX>
__global__ void __launch_bounds__(128)
    geglu_down_wg(const __grid_constant__ CUtensorMap ha,
                  const __grid_constant__ CUtensorMap wa,
                  const bf16* __restrict__ b2, bf16* __restrict__ out,
                  float* __restrict__ ws, int M, int d) {
  constexpr int BN = 64 * NX, LO = BN + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int c0 = blockIdx.x * BN, m0 = blockIdx.y * WG_BM;
  const int nk = 4 * d / WG_BK, splits = gridDim.z, z = blockIdx.z;
  float acc[NX][64];
  int col[NX], row[NX];
#pragma unroll
  for (int j = 0; j < NX; ++j) col[j] = c0 + 64 * j, row[j] = 0;
  wg_gemm<NX>(acc, smem, &ha, &wa, m0, col, row, z * nk / splits,
              (z + 1) * nk / splits);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  bf16* st = reinterpret_cast<bf16*>(smem);
  float* part = ws + (long long)z * M * d;
#pragma unroll
  for (int jt = 0; jt < NX; ++jt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = 64 * jt + 16 * warp + g + 8 * hh;
      const float bias = __bfloat162float(b2[c0 + c]);
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 4 * i + 2 * hh + e, r = 8 * i + 2 * t4 + e;
          if (splits > 1) {
            if (m0 + r < M) part[(long long)(m0 + r) * d + c0 + c] =
                acc[jt][k];
          } else {
            st[r * LO + c] = __float2bfloat16(acc[jt][k] + bias);
          }
        }
    }
  if (splits > 1) return;
  __syncthreads();
  store_tile<WG_BM, BN, 128>(st, out, d, m0, c0, M);
}

// out = bf16(sum over splits of ws + b2), the splits summed in order
__global__ void geglu_reduce(const float* __restrict__ ws,
                             const bf16* __restrict__ b2,
                             bf16* __restrict__ out, long long n, int d,
                             int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = __bfloat162float(b2[i % d]);
    for (int k = 0; k < splits; ++k) s += ws[k * n + i];
    out[i] = __float2bfloat16(s);
  }
}

// the split-sum of a split launch: out = bf16(b2 + the splits in order)
cudaError_t reduce_splits(const void* ws, const void* b2, void* out, int M,
                          int d, int splits, cudaStream_t stream) {
  const long long n = (long long)M * d;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  geglu_reduce<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const bf16*>(b2),
      static_cast<bf16*>(out), n, d, splits);
  return cudaGetLastError();
}

// the up GEMM; ln non-null folds the LayerNorm in (K9), launched to
// overlap the `ln_stats` launch just before it
cudaError_t launch_up_wg(const void* x, const void* w1, const void* b1,
                         void* h, int M, int d, const LnTile<>* ln,
                         cudaStream_t stream) {
  CUtensorMap xa, wa;
  if (!tensor_map(&xa, x, M, d, WG_BM) || !tensor_map(&wa, w1, d, 8 * d, 64))
    return cudaErrorInvalidValue;
  constexpr int smem = WgSmem<2>::BYTES;
  const dim3 grid(4 * d / 64, (M + WG_BM - 1) / WG_BM);
  const bf16* bias = static_cast<const bf16*>(b1);
  bf16* hb = static_cast<bf16*>(h);
  if (ln != nullptr) {
    constexpr int most = smem + LnTile<>::smem_bytes(1280);
    static const cudaError_t attr = cudaFuncSetAttribute(
        geglu_up_wg<LnTile<>>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        most);
    if (attr != cudaSuccess) return attr;
    return launch_dependent(geglu_up_wg<LnTile<>>, grid, 128,
                            smem + LnTile<>::smem_bytes(d), stream, xa, wa,
                            bias, hb, M, d, *ln);
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      geglu_up_wg<NoPrologue>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  geglu_up_wg<NoPrologue><<<grid, 128, smem, stream>>>(xa, wa, bias, hb, M, d,
                                                       NoPrologue{});
  return cudaGetLastError();
}

template <int NX>
cudaError_t launch_down_wg(const void* h, const void* w2, const void* b2,
                           void* out, void* ws, int M, int d, int splits,
                           cudaStream_t stream) {
  CUtensorMap ha, wa;
  if (!tensor_map(&ha, h, M, 4 * d, WG_BM) ||
      !tensor_map(&wa, w2, 4 * d, d, 64))
    return cudaErrorInvalidValue;
  constexpr int smem = WgSmem<NX>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      geglu_down_wg<NX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(d / (64 * NX), (M + WG_BM - 1) / WG_BM, splits);
  geglu_down_wg<NX><<<grid, 128, smem, stream>>>(
      ha, wa, static_cast<const bf16*>(b2), static_cast<bf16*>(out),
      static_cast<float*>(ws), M, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return reduce_splits(ws, b2, out, M, d, splits, stream);
}

}  // namespace

// K3, and K9 with the LayerNorm folded in. All tensors bf16, contiguous,
// 16-byte aligned: x (M, d), w1 (d, 8d), b1 (8d), w2 (4d, d), b2 (d), h
// (M, 4d) scratch, out (M, d); d in {320, 640, 1280}; down_bn
// (`geglu_down_wg`'s columns a block) 64 or 128, dividing d; splits in
// [1, 4d / 64], with ws a float32 (splits, M, d) workspace when above 1
// (`ops/geglu.py` `geglu_plan`). K9: ln_g and ln_b bf16 (d), stats a
// float32 (M, 2) scratch for the row statistics, ln_eps the LayerNorm's
// epsilon; all three pointers null for K3. Returns a cudaError_t (0 =
// launched; an invalid value also when a tensor map cannot be made).
extern "C" int gill_geglu_ff(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* h,
                             void* out, void* ws, const void* ln_g,
                             const void* ln_b, void* stats, float ln_eps,
                             int M, int d, int down_bn, int splits,
                             void* stream) {
  const bool fold_ln = ln_g != nullptr;
  if (M <= 0 || (d != 320 && d != 640 && d != 1280) || splits < 1 ||
      splits > 4 * d / WG_BK || (splits > 1 && ws == nullptr) ||
      (down_bn != 64 && down_bn != 128) || d % down_bn ||
      (ln_b != nullptr) != fold_ln || (stats != nullptr) != fold_ln)
    return (int)cudaErrorInvalidValue;
  if (!aligned16({x, w1, b1, w2, b2, h, out, ws, ln_g, ln_b, stats}))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LnTile<> ln = {static_cast<const float2*>(stats), static_cast<const bf16*>(ln_g),
               static_cast<const bf16*>(ln_b), M, d};
  if (fold_ln) {
    const cudaError_t e = launch_ln_stats(x, stats, M, d, ln_eps, st);
    if (e != cudaSuccess) return (int)e;
  }
  const cudaError_t e =
      launch_up_wg(x, w1, b1, h, M, d, fold_ln ? &ln : nullptr, st);
  if (e != cudaSuccess) return (int)e;
  return (int)(down_bn == 128
                   ? launch_down_wg<2>(h, w2, b2, out, ws, M, d, splits, st)
                   : launch_down_wg<1>(h, w2, b2, out, ws, M, d, splits, st));
}
