// Repeated-product tensor-core probe for Hopper (sm_90a), bf16 and int8.
//
// Replaces scripts/attn_mxu_probe.py `mk(m, k, n, dt, pet)` (Pallas kernel
// at :27, pallas_call at :40): out = a @ b issued `reps` times into one
// accumulator (the caller passes ops/mm_probe.py's REPS = 32, the
// original's grid length), a (M, K) and b (K, N) row-major, bf16 with fp32 sums or
// int8 with int32 sums. The TPU kernel revisits its output block on every
// step of a sequential grid so that nothing is loop-invariant; it isolates
// the matrix unit's rate with the operands resident in VMEM.
//
// What bounds it on an H100: the tensor cores' rate, by construction (the
// operands are read from device memory once and the product is issued
// `reps` times from shared memory). One operand of a probe case does not
// fit in the 227 KB of shared memory a block can hold (case C's A is
// 4 MB), so the work is split:
//  * `mm_rep`: one block = one (BM x 64) output tile and one K chunk of at
//    most 256; the block's A chunk and B chunk stay in shared memory, and
//    the product is issued `reps` times (WMMA 16x16x16, 4 warps, warp w
//    owning output columns [16w, 16w + 16) of every 16-row strip). As the
//    original adds each grid step's `dot` into its output block, each
//    repetition's product goes to fresh register fragments that are then
//    added into the running total, so the tensor cores' internal sums
//    never run at the total's magnitude. Each repetition re-loads its
//    fragments from shared memory behind a compiler barrier, so nothing is
//    hoisted out of the loop (the collapse the script's docstring warns
//    about). M is
//    zero-padded in shared memory to BM = 16 * ceil(M / 16) rows, at most
//    64 (M = 40 runs as 48 rows), and K to a multiple of 16: exact;
//  * `sum_chunks`: the K chunks' partial tiles summed in a fixed order,
//    a second pass with no atomics (none when K fits one chunk).
// bf16 uses WMMA bf16 fragments with fp32 accumulators; int8 uses the s8
// fragments with int32 accumulators. A WMMA s8 fragment's 16-byte depth
// slice must start 32-byte aligned, so int8 tiles sit in shared memory as
// [depth chunk][row][32 bytes], 16 of them used (as csrc/flash_attn_i8.cu
// does); B is stored transposed there, one row per output column.
// WMMA / mma.sync cannot reach the data-sheet peak, which needs wgmma: the
// share of the peak this probe prints measures that gap.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BN = 64, NTH = 128;
constexpr int LC = BN + 4;   // fp32 / int32 row stride of the staged tile

struct Params {
  const void* a;
  const void* b;
  void* out;       // (M, N) fp32 or int32, or the partials (nchunks, M, N)
  int M, N, K, KC, reps;
};

__host__ __device__ constexpr size_t a128(size_t n) { return (n + 127) / 128 * 128; }

// acc[i] += prod[i] elementwise (an accumulator fragment's elements sit
// at the same positions in every fragment of its type)
template <typename F, int MS>
__device__ __forceinline__ void add_into(F (&acc)[MS], const F (&prod)[MS]) {
#pragma unroll
  for (int i = 0; i < MS; ++i)
#pragma unroll
    for (int t = 0; t < acc[i].num_elements; ++t) acc[i].x[t] += prod[i].x[t];
}

// the staged (BM, BN) accumulator tile -> rows/cols inside (M, N)
template <typename T>
__device__ __forceinline__ void write_tile(T* dst, const T* cs, int BM, int m0,
                                           int n0, int M, int N, int tid) {
  for (int i = tid; i < BM * BN; i += NTH) {
    const int r = i / BN, c = i % BN;
    if (m0 + r < M && n0 + c < N) dst[(long long)(m0 + r) * N + n0 + c] = cs[r * LC + c];
  }
}

template <int MS>
__global__ void __launch_bounds__(NTH) mm_rep_bf16(Params p) {
  constexpr int BM = MS * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, k0 = blockIdx.z * p.KC;
  const int kc = min(p.KC, p.K - k0);
  const int k16 = (kc + 15) / 16 * 16;
  const int LA = p.KC + 8, LB = BN + 8;
  bf16* as = reinterpret_cast<bf16*>(smem);                         // [BM][LA]
  bf16* bs = reinterpret_cast<bf16*>(smem + a128(2 * BM * LA));     // [KC][LB]
  float* cs = reinterpret_cast<float*>(
      smem + a128(2 * BM * LA) + a128(2 * p.KC * LB));              // [BM][LC]
  const bf16* a = static_cast<const bf16*>(p.a);
  const bf16* b = static_cast<const bf16*>(p.b);
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < BM * k16; i += NTH) {
    const int r = i / k16, c = i % k16;
    as[r * LA + c] = (m0 + r < p.M && c < kc)
                         ? a[(long long)(m0 + r) * p.K + k0 + c] : zero;
  }
  for (int i = tid; i < k16 * BN; i += NTH) {
    const int r = i / BN, c = i % BN;
    bs[r * LB + c] = (r < kc && n0 + c < p.N)
                         ? b[(long long)(k0 + r) * p.N + n0 + c] : zero;
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MS], prod[MS];
#pragma unroll
  for (int i = 0; i < MS; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int rep = 0; rep < p.reps; ++rep) {
    asm volatile("" ::: "memory");   // re-load the fragments every repetition
#pragma unroll
    for (int i = 0; i < MS; ++i) wmma::fill_fragment(prod[i], 0.f);
    for (int kk = 0; kk < k16; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, bs + kk * LB + warp * 16, LB);
#pragma unroll
      for (int i = 0; i < MS; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, as + i * 16 * LA + kk, LA);
        wmma::mma_sync(prod[i], af, bf, prod[i]);
      }
    }
    add_into(acc, prod);
  }
#pragma unroll
  for (int i = 0; i < MS; ++i)
    wmma::store_matrix_sync(cs + i * 16 * LC + warp * 16, acc[i], LC,
                            wmma::mem_row_major);
  __syncthreads();
  float* out = static_cast<float*>(p.out) + (long long)blockIdx.z * p.M * p.N;
  write_tile(out, cs, BM, m0, n0, p.M, p.N, tid);
}

template <int MS>
__global__ void __launch_bounds__(NTH) mm_rep_i8(Params p) {
  constexpr int BM = MS * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, k0 = blockIdx.z * p.KC;
  const int kc = min(p.KC, p.K - k0);
  const int nch = (kc + 15) / 16;               // 16-deep chunks
  const int nch_max = p.KC / 16;
  signed char* as = reinterpret_cast<signed char*>(smem);  // [ch][BM][32]
  signed char* bs = reinterpret_cast<signed char*>(
      smem + a128(32 * nch_max * BM));                       // [ch][BN][32]
  int* cs = reinterpret_cast<int*>(smem + a128(32 * nch_max * BM) +
                                   a128(32 * nch_max * BN)); // [BM][LC]
  const signed char* a = static_cast<const signed char*>(p.a);
  const signed char* b = static_cast<const signed char*>(p.b);
  for (int i = tid; i < BM * nch * 16; i += NTH) {
    const int r = i / (nch * 16), c = i % (nch * 16);
    as[((c >> 4) * BM + r) * 32 + (c & 15)] =
        (m0 + r < p.M && c < kc) ? a[(long long)(m0 + r) * p.K + k0 + c] : 0;
  }
  for (int i = tid; i < nch * 16 * BN; i += NTH) {
    const int r = i / BN, c = i % BN;        // depth r, output column c
    bs[((r >> 4) * BN + c) * 32 + (r & 15)] =
        (r < kc && n0 + c < p.N) ? b[(long long)(k0 + r) * p.N + n0 + c] : 0;
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[MS], prod[MS];
#pragma unroll
  for (int i = 0; i < MS; ++i) wmma::fill_fragment(acc[i], 0);
  for (int rep = 0; rep < p.reps; ++rep) {
    asm volatile("" ::: "memory");   // re-load the fragments every repetition
#pragma unroll
    for (int i = 0; i < MS; ++i) wmma::fill_fragment(prod[i], 0);
    for (int ch = 0; ch < nch; ++ch) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bf;
      wmma::load_matrix_sync(bf, bs + (ch * BN + warp * 16) * 32, 32);
#pragma unroll
      for (int i = 0; i < MS; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> af;
        wmma::load_matrix_sync(af, as + (ch * BM + i * 16) * 32, 32);
        wmma::mma_sync(prod[i], af, bf, prod[i]);
      }
    }
    add_into(acc, prod);
  }
#pragma unroll
  for (int i = 0; i < MS; ++i)
    wmma::store_matrix_sync(cs + i * 16 * LC + warp * 16, acc[i], LC,
                            wmma::mem_row_major);
  __syncthreads();
  int* out = static_cast<int*>(p.out) + (long long)blockIdx.z * p.M * p.N;
  write_tile(out, cs, BM, m0, n0, p.M, p.N, tid);
}

// out[i] = sum over c of part[c][i], c = 0, 1, ... in order
__global__ void sum_chunks_f32(const float* part, float* out, long long n,
                               int nchunks) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < nchunks; ++c) s += part[c * n + i];
    out[i] = s;
  }
}

// int64 sums, so an intermediate cannot wrap; the caller's result is in
// int32 range
__global__ void sum_chunks_i32(const int* part, int* out, long long n,
                               int nchunks) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long s = 0;
    for (int c = 0; c < nchunks; ++c) s += part[c * n + i];
    out[i] = (int)s;
  }
}

size_t smem_bytes(bool i8, int MS, int KC) {
  const int BM = MS * 16;
  if (i8) return a128(32 * (KC / 16) * BM) + a128(32 * (KC / 16) * BN) + 4 * BM * LC;
  return a128(2 * BM * (KC + 8)) + a128(2 * KC * (BN + 8)) + 4 * BM * LC;
}

template <int MS>
cudaError_t launch_rep(bool i8, const Params& p, int nchunks, cudaStream_t st) {
  const size_t smem = smem_bytes(i8, MS, p.KC);
  dim3 grid((p.N + BN - 1) / BN, (p.M + MS * 16 - 1) / (MS * 16), nchunks);
  cudaError_t e;
  if (i8) {
    e = cudaFuncSetAttribute(mm_rep_i8<MS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    mm_rep_i8<MS><<<grid, NTH, smem, st>>>(p);
  } else {
    e = cudaFuncSetAttribute(mm_rep_bf16<MS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    mm_rep_bf16<MS><<<grid, NTH, smem, st>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// a (M, K), b (K, N) row-major contiguous, bf16 (i8 = 0) or int8 (i8 = 1);
// out (M, N) fp32 or int32 contiguous; part (nchunks, M, N) of out's type
// when nchunks = ceil(K / kc) > 1, else unused. kc: a multiple of 16, at
// most 256. reps: the repetitions (ops/mm_probe.py's REPS). Returns a
// cudaError_t (0 = launched).
extern "C" int gill_mm_probe(const void* a, const void* b, void* out,
                             void* part, int i8, int M, int N, int K, int kc,
                             int reps, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || reps <= 0 || kc <= 0 || kc % 16 ||
      kc > 256)
    return (int)cudaErrorInvalidValue;
  const int nchunks = (K + kc - 1) / kc;
  if (nchunks > 65535) return (int)cudaErrorInvalidValue;
  Params p{a, b, nchunks > 1 ? part : out, M, N, K, kc, reps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ms = min(4, (M + 15) / 16);
  cudaError_t e;
  switch (ms) {
    case 1: e = launch_rep<1>(i8, p, nchunks, st); break;
    case 2: e = launch_rep<2>(i8, p, nchunks, st); break;
    case 3: e = launch_rep<3>(i8, p, nchunks, st); break;
    default: e = launch_rep<4>(i8, p, nchunks, st); break;
  }
  if (e != cudaSuccess || nchunks == 1) return (int)e;
  const long long n = (long long)M * N;
  const int blocks = (int)min((n + 255) / 256, 4096LL);
  if (i8)
    sum_chunks_i32<<<blocks, 256, 0, st>>>(static_cast<const int*>(part),
                                           static_cast<int*>(out), n, nchunks);
  else
    sum_chunks_f32<<<blocks, 256, 0, st>>>(static_cast<const float*>(part),
                                           static_cast<float*>(out), n, nchunks);
  return (int)cudaGetLastError();
}
