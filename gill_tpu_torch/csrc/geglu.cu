// Fused GEGLU feed-forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces gill_tpu/ops/geglu.py `geglu_ff` (Pallas body `_kernel`):
//   out = (gelu(x Wg + bg) * (x Wv + bv)) W2 + b2,
// with w1 (d, 8d) packing [val | gate] column halves, w2 (4d, d), and the
// EXACT erf gelu of the composed path (diffusers GEGLU; gill_tpu
// models/sd/unet.py `_geglu_ff`), not the Pallas kernel's tanh form.
//
// What bounds it on an H100: 24 d^2 FLOPs a row, on the bf16 tensor cores;
// every block streams all of W1 and W2 (12 d^2 bf16, from the 50 MB L2),
// so the rows a block owns set the weight reuse. Unfused, the (M, 8d)
// projection and the (M, 4d) gated intermediate make two extra round trips
// through HBM; here the intermediate never leaves the SM. Design:
//  * one block = BM rows of x and all d output columns; 8 warps;
//  * the (BM, d) fp32 output accumulator lives in WMMA fragments in
//    registers, BM * d = 20480 (10 16x16 fragments a warp), so BM = 64 /
//    32 / 16 at d = 320 / 640 / 1280. (A 64-row fp32 tile at d = 1280
//    would be 320 KB, over the 227 KB of shared memory; shrinking BM keeps
//    one pass over the first product, where splitting the output columns
//    would recompute it once per split.)
//  * the inner 4d dimension is walked in chunks of NC = 64: the chunk's
//    val and gate columns accumulate in fp32 fragments over staged W1
//    tiles (bf16 16x16x16 WMMA), get bias + erf-gelu + gating in shared
//    memory, are rounded to bf16 (as the Pallas kernel feeds its second
//    product) and are contracted at once into the output fragments over
//    staged W2 rows; W1 and W2 tiles are double-buffered with cp.async, so
//    the next tile loads while the current one computes;
//  * when M / BM blocks cannot fill the SMs (d = 640 and 1280 at the
//    UNet's token counts), grid.y splits the inner chunks; each split
//    writes fp32 partials to a workspace and a second kernel sums them in a
//    fixed order and adds b2, so the result stays deterministic.
// TMA, deeper pipelines and wgmma are later work.
//
// The same kernel, with LN = true, replaces `_kernel_ln` (geglu_ff with
// ln_gamma/ln_beta, GILL_SD_FUSE_LN=1): x is the raw residual stream and
// the block normalizes its resident x tile in place (common.cuh
// `ln_rows_inplace`, `_ln_rows`' rounding points) before the first
// product, so the normalized tensor never exists in device memory. The
// gelu stays the exact erf form; `_kernel_ln`'s tanh form is Mosaic's lack
// of erf. LN = false is the kernel K3 always was.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int NT = 256;          // 8 warps
constexpr int NW = NT / 32;
constexpr int NC = 64;           // inner columns per chunk (each half)
constexpr int KT = 64;           // W1 rows per staged tile
constexpr int PAD = 8;           // bf16 row padding (16 bytes)
constexpr int OF = 10;           // output fragments a warp owns

template <int D> struct GCfg {
  static constexpr int BM = 20480 / D;        // 64 / 32 / 16
  static constexpr int LX = D + PAD;          // xs, w2s row stride
  static constexpr int LW1 = 2 * NC + PAD;    // w1s row stride
  static constexpr int LST = 2 * NC + 4;      // st row stride (fp32)
  static constexpr int LH = NC + PAD;         // hs row stride
  static constexpr int P1 = BM / 16;          // phase-1 fragments a warp owns
};

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <int D> struct GSmem {
  using C = GCfg<D>;
  static constexpr size_t xs = 0;
  static constexpr size_t w1s = xs + align128(sizeof(bf16) * C::BM * C::LX);
  static constexpr size_t st = w1s + align128(sizeof(bf16) * 2 * KT * C::LW1);
  static constexpr size_t hs = st + align128(sizeof(float) * C::BM * C::LST);
  static constexpr size_t w2s = hs + align128(sizeof(bf16) * C::BM * C::LH);
  static constexpr size_t ost = w2s + align128(sizeof(bf16) * 2 * 16 * C::LX);
  static constexpr size_t total = ost + sizeof(float) * NW * 256;
};

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

template <int D, bool LN>
__global__ void __launch_bounds__(NT)
    geglu_fwd(const bf16* __restrict__ x, const bf16* __restrict__ ln_g,
              const bf16* __restrict__ ln_b, float ln_eps,
              const bf16* __restrict__ w1,
              const bf16* __restrict__ b1, const bf16* __restrict__ w2,
              const bf16* __restrict__ b2, bf16* __restrict__ out,
              float* __restrict__ ws, int M) {
  using C = GCfg<D>;
  using S = GSmem<D>;
  constexpr int BM = C::BM, INNER = 4 * D, NCF = D / 16;
  static_assert(BM % 16 == 0 && D % KT == 0 && (BM / 16) * NCF == NW * OF,
                "tile");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + S::xs);     // [BM][LX]
  bf16* w1s = reinterpret_cast<bf16*>(smem + S::w1s);   // [KT][LW1] val|gate
  float* st = reinterpret_cast<float*>(smem + S::st);   // [BM][LST]
  bf16* hs = reinterpret_cast<bf16*>(smem + S::hs);     // [BM][LH]
  bf16* w2s = reinterpret_cast<bf16*>(smem + S::w2s);   // [16][LX]
  float* ost = reinterpret_cast<float*>(smem + S::ost); // [NW][16][16]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM;
  const int splits = gridDim.y, split = blockIdx.y;
  const int nchunks = INNER / NC;
  const int c_begin = split * nchunks / splits;
  const int c_end = (split + 1) * nchunks / splits;

  // x rows m0..m0+BM, zero past M (16-byte loads)
  for (int i = tid; i < BM * (D / 8); i += NT) {
    const int r = i / (D / 8), q = i % (D / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + r < M)
      v = reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * D)[q];
    *reinterpret_cast<uint4*>(xs + r * C::LX + q * 8) = v;
  }
  if constexpr (LN) {
    // the rows are written; the first barrier of the loop below orders
    // the normalized tile before any product reads it
    __syncthreads();
    ln_rows_inplace<D>(xs, C::LX, BM, ln_g, ln_b, ln_eps, warp, NW, lane);
  }

  FragC acc[OF];
#pragma unroll
  for (int i = 0; i < OF; ++i) wmma::fill_fragment(acc[i], 0.f);

  // the phase-1 fragments of this warp share one 16-row slab
  const int p1_row = (warp * C::P1) / 8;

  // W1 k-tile (KT rows, the chunk's val | gate columns) into buffer buf
  auto load_w1 = [&](int buf, int n0, int k0) {
    bf16* dst = w1s + buf * KT * C::LW1;
    for (int i = tid; i < KT * 16; i += NT) {
      const int r = i / 16, part = i % 16, half = part / 8, q = part % 8;
      cp_async16(dst + r * C::LW1 + half * NC + q * 8,
                 w1 + (long long)(k0 + r) * (2 * INNER) + half * INNER + n0 +
                     q * 8);
    }
  };
  // 16 rows of W2 into buffer buf
  auto load_w2 = [&](int buf, int row0) {
    bf16* dst = w2s + buf * 16 * C::LX;
    for (int i = tid; i < 16 * (D / 8); i += NT) {
      const int r = i / (D / 8), q = i % (D / 8);
      cp_async16(dst + r * C::LX + q * 8, w2 + (long long)(row0 + r) * D + q * 8);
    }
  };
  constexpr int NKT = D / KT;

  for (int c = c_begin; c < c_end; ++c) {
    const int n0 = c * NC;
    FragC h1[C::P1];
#pragma unroll
    for (int i = 0; i < C::P1; ++i) wmma::fill_fragment(h1[i], 0.f);

    // phase 1, double-buffered: tile t+1 loads while tile t computes
    load_w1(0, n0, 0);
    cp_async_commit();
    for (int t = 0; t < NKT; ++t) {
      if (t + 1 < NKT) load_w1((t + 1) & 1, n0, (t + 1) * KT);
      cp_async_commit();
      cp_async_wait_prior<1>();
      __syncthreads();
      const bf16* w1t = w1s + (t & 1) * KT * C::LW1;
#pragma unroll
      for (int kk = 0; kk < KT; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, xs + p1_row * 16 * C::LX + t * KT + kk,
                               C::LX);
#pragma unroll
        for (int i = 0; i < C::P1; ++i) {
          const int col = (warp * C::P1 + i) % 8;
          FragB b;
          wmma::load_matrix_sync(b, w1t + kk * C::LW1 + col * 16, C::LW1);
          wmma::mma_sync(h1[i], a, b, h1[i]);
        }
      }
      __syncthreads();  // the buffer is free for the prefetch of tile t+2
    }
    load_w2(0, n0);     // overlaps the gating below
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < C::P1; ++i) {
      const int col = (warp * C::P1 + i) % 8;
      wmma::store_matrix_sync(st + p1_row * 16 * C::LST + col * 16, h1[i],
                              C::LST, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < BM * NC; i += NT) {
      const int r = i / NC, cc = i % NC;
      const float v = st[r * C::LST + cc] + __bfloat162float(b1[n0 + cc]);
      const float g =
          st[r * C::LST + NC + cc] + __bfloat162float(b1[INNER + n0 + cc]);
      hs[r * C::LH + cc] = __float2bfloat16(v * gelu_erf(g));
    }

    // phase 2, double-buffered over the chunk's four 16-row W2 tiles
#pragma unroll
    for (int t = 0; t < NC / 16; ++t) {
      if (t + 1 < NC / 16) load_w2((t + 1) & 1, n0 + (t + 1) * 16);
      cp_async_commit();
      cp_async_wait_prior<1>();
      __syncthreads();  // hs is written; W2 tile t has landed
      const bf16* w2t = w2s + (t & 1) * 16 * C::LX;
#pragma unroll
      for (int i = 0; i < OF; ++i) {
        const int f = warp * OF + i, rf = f / NCF, cf = f % NCF;
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, hs + rf * 16 * C::LH + t * 16, C::LH);
        wmma::load_matrix_sync(b, w2t + cf * 16, C::LX);
        wmma::mma_sync(acc[i], a, b, acc[i]);
      }
      __syncthreads();  // the buffer is free for the prefetch of tile t+2
    }
  }

  float* my = ost + warp * 256;
#pragma unroll
  for (int i = 0; i < OF; ++i) {
    const int f = warp * OF + i, rf = f / NCF, cf = f % NCF;
    wmma::store_matrix_sync(my, acc[i], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = lane * 8 + j, r = m0 + rf * 16 + e / 16;
      const int col = cf * 16 + e % 16;
      if (r < M) {
        if (splits == 1)
          out[(long long)r * D + col] =
              __float2bfloat16(my[e] + __bfloat162float(b2[col]));
        else
          ws[((long long)split * M + r) * D + col] = my[e];
      }
    }
    __syncwarp();
  }
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

template <int D> int row_blocks(int M) {
  return (M + GCfg<D>::BM - 1) / GCfg<D>::BM;
}

template <int D, bool LN>
cudaError_t launch(const void* x, const void* ln_g, const void* ln_b,
                   float ln_eps, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, void* ws, int M,
                   int splits, cudaStream_t stream) {
  constexpr size_t smem = GSmem<D>::total;
  cudaError_t e = cudaFuncSetAttribute(
      geglu_fwd<D, LN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(row_blocks<D>(M), splits);
  geglu_fwd<D, LN><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln_g),
      static_cast<const bf16*>(ln_b), ln_eps, static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out),
      static_cast<float*>(ws), M);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long n = (long long)M * D;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  geglu_reduce<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const bf16*>(b2),
      static_cast<bf16*>(out), n, D, splits);
  return cudaGetLastError();
}

int splits_for(int M, int d, int num_sms) {
  int rb;
  switch (d) {
    case 320: rb = row_blocks<320>(M); break;
    case 640: rb = row_blocks<640>(M); break;
    case 1280: rb = row_blocks<1280>(M); break;
    default: return -1;
  }
  const int nchunks = 4 * d / NC;
  int s = num_sms / (rb > 0 ? rb : 1);
  return s < 1 ? 1 : (s > nchunks ? nchunks : s);
}

template <bool LN>
int dispatch(const void* x, const void* ln_g, const void* ln_b, float ln_eps,
             const void* w1, const void* b1, const void* w2, const void* b2,
             void* out, void* ws, int M, int d, int splits, void* stream) {
  if (M <= 0 || splits < 1 || splits > 4 * d / NC ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 320:
      return (int)launch<320, LN>(x, ln_g, ln_b, ln_eps, w1, b1, w2, b2, out,
                                  ws, M, splits, st);
    case 640:
      return (int)launch<640, LN>(x, ln_g, ln_b, ln_eps, w1, b1, w2, b2, out,
                                  ws, M, splits, st);
    case 1280:
      return (int)launch<1280, LN>(x, ln_g, ln_b, ln_eps, w1, b1, w2, b2, out,
                                   ws, M, splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// How many inner-dimension splits gill_geglu_ff will use for (M, d) on a
// card with num_sms SMs: the caller allocates a float32 workspace of
// splits * M * d elements when this is above 1. -1 for an unsupported d.
extern "C" int gill_geglu_ff_splits(int M, int d, int num_sms) {
  return splits_for(M, d, num_sms);
}

// All tensors bf16 and contiguous with 16-byte aligned bases: x (M, d),
// w1 (d, 8d), b1 (8d), w2 (4d, d), b2 (d), out (M, d); d in
// {320, 640, 1280}; ws as sized by gill_geglu_ff_splits (may be null when
// splits is 1). Returns a cudaError_t (0 = launched).
extern "C" int gill_geglu_ff(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out,
                             void* ws, int M, int d, int splits,
                             void* stream) {
  return dispatch<false>(x, nullptr, nullptr, 0.f, w1, b1, w2, b2, out, ws, M,
                         d, splits, stream);
}

// gill_geglu_ff on LN(x): ln_g and ln_b bf16 (d), 16-byte aligned, and
// ln_eps the LayerNorm's epsilon; x is the raw (un-normalized) input.
extern "C" int gill_geglu_ff_ln(const void* x, const void* ln_g,
                                const void* ln_b, float ln_eps, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                void* out, void* ws, int M, int d, int splits,
                                void* stream) {
  return dispatch<true>(x, ln_g, ln_b, ln_eps, w1, b1, w2, b2, out, ws, M, d,
                        splits, stream);
}
