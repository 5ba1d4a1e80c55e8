// W8A16 matmul for Hopper (sm_90a): y = (x W8) * ws + b.
//
// Replaces gill_tpu/ops/w8_matmul.py `w8_matmul` (Pallas `_kernel`) and
// `w8_matmul_stacked` (`_kernel_stacked`): x (M, K) bf16 or fp32, W8 (K, N)
// int8 with a row stride (one layer of a stacked (L, K, N) weight is a view,
// so the stacked kernel is this kernel on `w8[idx]`), per-output-channel
// fp32 scales ws (N,) applied once after the K-sum, an optional bias b (N,)
// in fp32 or bf16, fp32 accumulation, one rounding to x's dtype.
//
// What bounds it on an H100: the weight stream. At decode sizes (M = 8-16)
// a call reads K * N int8 bytes and does 2 M K N operations, 2 M ops a
// byte, far under the 295 bf16 operations a byte at which the tensor cores
// would bound it; at OPT-6.7B one decode step streams 6.44 GB of int8
// weights, >= 1.9 ms at 3.35 TB/s. Design:
//  * bf16 x: one block = up to MT rows of x (16 or 64) x BN = 128 output
//    columns, 8 warps, one 16-wide column of WMMA fragments a warp. The
//    K range is walked in tiles of KT = 64 rows; each tile's int8 weights
//    and x rows arrive by cp.async in a ring of NS = 4 stages, so three
//    tiles are in flight while one computes. The int8 tile is widened to
//    bf16 in shared memory (exact: |w| <= 127) and multiplied on the
//    tensor cores (bf16 16x16x16, fp32 accumulation): the products are the
//    exact ones an fp32 FMA would form, only the summation order differs;
//  * fp32 x (the sequential decode path, M = 1): CUDA-core fp32 FMA, each
//    thread 4 adjacent columns (one 4-byte load a row), up to 4 rows of x
//    a block, the x rows staged in shared memory;
//  * N = 4096 gives only 32 column blocks for 132 SMs, so grid.z splits
//    the K range; each split writes fp32 partial sums to a workspace and a
//    second kernel adds them in a fixed order, then applies ws and b, so
//    the result is deterministic. x (<= 512 KB) stays in L2 across blocks.
// TMA, wgmma and a fused split reduction are later work.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int NT = 256;          // 8 warps
constexpr int NW = NT / 32;
constexpr int BN = 128;          // output columns per block (tensor cores)
constexpr int KT = 64;           // K rows per pipeline stage
constexpr int NS = 4;            // stages in the cp.async ring
constexpr int LWB = BN + 8;      // bf16 weight tile row stride
constexpr int LX = KT + 8;       // bf16 x tile row stride
constexpr int FC = 4;            // columns per thread (fp32 path)
constexpr int FBN = NT * FC;     // output columns per block (fp32 path)
constexpr int MR = 4;            // x rows per block (fp32 path)
constexpr int KC = 128;          // K rows per staged x chunk (fp32 path)

struct Args {
  const void* x;
  const int8_t* w;
  const float* ws;
  const void* b;
  void* out;
  float* part;
  long long ldw;
  int M, K, N, b_kind, splits;   // b_kind: 0 none, 1 fp32, 2 bf16
};

__device__ __forceinline__ float bias_at(const Args& a, int c) {
  if (a.b_kind == 1) return static_cast<const float*>(a.b)[c];
  if (a.b_kind == 2) return __bfloat162float(static_cast<const bf16*>(a.b)[c]);
  return 0.f;
}

__device__ __forceinline__ void store_out(float* o, long long i, float v) {
  o[i] = v;
}
__device__ __forceinline__ void store_out(bf16* o, long long i, float v) {
  o[i] = __float2bfloat16(v);
}

template <int MT> struct TcSmem {
  static constexpr size_t w8 = 0;                                 // [NS][KT][BN]
  static constexpr size_t xs = w8 + NS * KT * BN;                 // [NS][MT][LX]
  static constexpr size_t wb = xs + sizeof(bf16) * NS * MT * LX;  // [KT][LWB]
  static constexpr size_t ost = wb + sizeof(bf16) * KT * LWB;     // [NW][16][16]
  static constexpr size_t total = ost + sizeof(float) * NW * 256;
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

template <int MT>
__global__ void __launch_bounds__(NT) w8_tc(Args a) {
  using S = TcSmem<MT>;
  constexpr int RF = MT / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* w8s = reinterpret_cast<int8_t*>(smem + S::w8);
  bf16* xs = reinterpret_cast<bf16*>(smem + S::xs);
  bf16* wb = reinterpret_cast<bf16*>(smem + S::wb);
  float* ost = reinterpret_cast<float*>(smem + S::ost);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * MT;
  const int nkt = a.K / KT;
  const int t0 = blockIdx.z * nkt / a.splits;
  const int t1 = (blockIdx.z + 1) * nkt / a.splits;
  const int mrows = min(MT, a.M - m0);
  const int nrf = (mrows + 15) / 16;
  const bf16* x = static_cast<const bf16*>(a.x);

  // x rows past M stay zero in every stage (the copies never write them)
  if (mrows < MT) {
    for (int i = tid; i < NS * MT * LX; i += NT)
      if ((i / LX) % MT >= mrows) xs[i] = __float2bfloat16(0.f);
  }

  auto load = [&](int stage, int t) {
    const int k0 = t * KT;
    int8_t* wd = w8s + stage * KT * BN;
    for (int i = tid; i < KT * (BN / 16); i += NT) {
      const int r = i / (BN / 16), q = i % (BN / 16);
      cp_async16(wd + r * BN + q * 16, a.w + (k0 + r) * a.ldw + n0 + q * 16);
    }
    bf16* xd = xs + stage * MT * LX;
    for (int i = tid; i < mrows * (KT / 8); i += NT) {
      const int r = i / (KT / 8), q = i % (KT / 8);
      cp_async16(xd + r * LX + q * 8,
                 x + (long long)(m0 + r) * a.K + k0 + q * 8);
    }
  };

  FragC acc[RF];
#pragma unroll
  for (int r = 0; r < RF; ++r) wmma::fill_fragment(acc[r], 0.f);

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (t0 + s < t1) load(s, t0 + s);
    cp_async_commit();
  }
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0;
    cp_async_wait_prior<NS - 2>();   // tile t has landed
    __syncthreads();                 // ... for every thread; tile t-1 is done
    if (t + NS - 1 < t1) load((i + NS - 1) % NS, t + NS - 1);
    cp_async_commit();

    // widen the int8 tile to bf16 (exact), 16 weights a thread a pass
    const int8_t* src = w8s + (i % NS) * KT * BN;
    for (int e = tid * 16; e < KT * BN; e += NT * 16) {
      const int r = e / BN, c = e % BN;
      const int4 v = *reinterpret_cast<const int4*>(src + e);
      const int8_t* pv = reinterpret_cast<const int8_t*>(&v);
      __align__(16) bf16 o[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) o[j] = __int2bfloat16_rn(pv[j]);
      uint4* dst = reinterpret_cast<uint4*>(wb + r * LWB + c);
      dst[0] = reinterpret_cast<const uint4*>(o)[0];
      dst[1] = reinterpret_cast<const uint4*>(o)[1];
    }
    __syncthreads();

    const bf16* xt = xs + (i % NS) * MT * LX;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      FragB fb;
      wmma::load_matrix_sync(fb, wb + kk * LWB + warp * 16, LWB);
#pragma unroll
      for (int r = 0; r < RF; ++r) {
        if (r < nrf) {
          FragA fa;
          wmma::load_matrix_sync(fa, xt + r * 16 * LX + kk, LX);
          wmma::mma_sync(acc[r], fa, fb, acc[r]);
        }
      }
    }
  }

  float* my = ost + warp * 256;
#pragma unroll
  for (int r = 0; r < RF; ++r) {
    if (r >= nrf) break;
    wmma::store_matrix_sync(my, acc[r], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = lane * 8 + j;
      const int row = m0 + r * 16 + e / 16, col = n0 + warp * 16 + e % 16;
      if (row < a.M) {
        const long long o = (long long)row * a.N + col;
        if (a.splits == 1)
          store_out(static_cast<bf16*>(a.out), o,
                    my[e] * a.ws[col] + bias_at(a, col));
        else
          a.part[(long long)blockIdx.z * a.M * a.N + o] = my[e];
      }
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(NT) w8_f32(Args a) {
  __shared__ float xsh[MR][KC];
  const int tid = threadIdx.x;
  const int col = blockIdx.x * FBN + tid * FC, m0 = blockIdx.y * MR;
  const int nkt = a.K / KC;
  const int t0 = blockIdx.z * nkt / a.splits;
  const int t1 = (blockIdx.z + 1) * nkt / a.splits;
  const bool live = col < a.N;
  const float* x = static_cast<const float*>(a.x);

  float acc[MR][FC];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int j = 0; j < FC; ++j) acc[r][j] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int k0 = t * KC;
    __syncthreads();
    for (int i = tid; i < MR * KC; i += NT) {
      const int r = i / KC, kk = i % KC;
      xsh[r][kk] = m0 + r < a.M ? x[(long long)(m0 + r) * a.K + k0 + kk] : 0.f;
    }
    __syncthreads();
    if (live) {
      const int8_t* wp = a.w + (long long)k0 * a.ldw + col;
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        const char4 w = *reinterpret_cast<const char4*>(wp + kk * a.ldw);
        const float wf[FC] = {(float)w.x, (float)w.y, (float)w.z, (float)w.w};
#pragma unroll
        for (int r = 0; r < MR; ++r)
#pragma unroll
          for (int j = 0; j < FC; ++j) acc[r][j] = fmaf(xsh[r][kk], wf[j], acc[r][j]);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    const int row = m0 + r;
    if (row >= a.M) break;
#pragma unroll
    for (int j = 0; j < FC; ++j) {
      const long long o = (long long)row * a.N + col + j;
      if (a.splits == 1)
        store_out(static_cast<float*>(a.out), o,
                  acc[r][j] * a.ws[col + j] + bias_at(a, col + j));
      else
        a.part[(long long)blockIdx.z * a.M * a.N + o] = acc[r][j];
    }
  }
}

// out = (sum over splits of the partials, in split order) * ws + b
template <typename T>
__global__ void w8_reduce(Args a) {
  const long long n = (long long)a.M * a.N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % a.N);
    float s = 0.f;
    for (int k = 0; k < a.splits; ++k) s += a.part[k * n + i];
    store_out(static_cast<T*>(a.out), i, s * a.ws[c] + bias_at(a, c));
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

int clamp_splits(int want, int most) {
  return want < 1 ? 1 : (want > most ? most : want);
}

// K-range splits for (M, K, N): enough blocks for about three (tensor
// cores) or four (fp32) resident blocks an SM
int splits_for(int M, int K, int N, int is_f32, int num_sms) {
  if (is_f32) {
    const int blocks = ceil_div(N, FBN) * ceil_div(M, MR);
    return clamp_splits(ceil_div(4 * num_sms, blocks), K / KC);
  }
  const int mt = M <= 16 ? 16 : 64;
  const int blocks = (N / BN) * ceil_div(M, mt);
  return clamp_splits(ceil_div(3 * num_sms, blocks), K / KT);
}

template <int MT> cudaError_t launch_tc(const Args& a, cudaStream_t st) {
  constexpr size_t smem = TcSmem<MT>::total;
  cudaError_t e = cudaFuncSetAttribute(
      w8_tc<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.N / BN, ceil_div(a.M, MT), a.splits);
  w8_tc<MT><<<grid, NT, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The K-range splits gill_w8_matmul will use: the caller allocates a
// float32 workspace of splits * M * N elements when this is above 1.
extern "C" int gill_w8_matmul_splits(int M, int K, int N, int is_f32,
                                     int num_sms) {
  return splits_for(M, K, N, is_f32, num_sms);
}

// x (M, K) contiguous, bf16 (is_f32 = 0) or fp32 (is_f32 = 1), 16-byte
// aligned; w (K rows of N int8, row stride ldw, 16-byte aligned rows);
// ws (N,) fp32; b (N,) per b_kind (0 none, 1 fp32, 2 bf16); out (M, N)
// contiguous in x's dtype; part as sized by gill_w8_matmul_splits (null
// when splits is 1). 1 <= M <= 256, K % 512 == 0, N % 512 == 0.
// Returns a cudaError_t (0 = launched).
extern "C" int gill_w8_matmul(int is_f32, const void* x, const void* w,
                              long long ldw, const void* ws, const void* b,
                              int b_kind, void* out, void* part, int M, int K,
                              int N, int splits, void* stream) {
  if (M < 1 || M > 256 || K % 512 || N % 512 || ldw < N || ldw % 16 ||
      splits < 1 || splits > K / (is_f32 ? KC : KT) ||
      (splits > 1 && part == nullptr) || b_kind < 0 || b_kind > 2)
    return (int)cudaErrorInvalidValue;
  Args a{x, static_cast<const int8_t*>(w), static_cast<const float*>(ws), b,
         out, static_cast<float*>(part), ldw, M, K, N, b_kind, splits};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_f32) {
    dim3 grid(ceil_div(N, FBN), ceil_div(M, MR), splits);
    w8_f32<<<grid, NT, 0, st>>>(a);
    e = cudaGetLastError();
  } else {
    e = M <= 16 ? launch_tc<16>(a, st) : launch_tc<64>(a, st);
  }
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long n = (long long)M * N;
  const int blocks = (int)((n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048);
  if (is_f32)
    w8_reduce<float><<<blocks, 256, 0, st>>>(a);
  else
    w8_reduce<bf16><<<blocks, 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}
