// Repeated-product tensor-core probe for Hopper (sm_90a), bf16 and int8,
// on wgmma.
//
// Replaces scripts/attn_mxu_probe.py `mk(m, k, n, dt, pet)` (Pallas kernel
// at :27, pallas_call at :40): out = a @ b issued `reps` times into one
// accumulator (the caller passes ops/mm_probe.py's REPS = 32, the
// original's grid length), a (M, K) and b (K, N) row-major, bf16 with fp32
// sums or int8 with int32 sums. The TPU kernel revisits its output block on
// every step of a sequential grid so that nothing is loop-invariant; it
// isolates the matrix unit's rate with the operands resident in VMEM.
//
// What bounds it on an H100: the tensor cores' rate, by construction (the
// operands are read from device memory once and the product is issued
// `reps` times from shared memory), which only wgmma reaches. Design:
//  * one block computes a 64 x 128 output tile over one K chunk
//    of KCB = 128, 256 or 512 bytes (`mm_plan` in ops/mm_probe.py: the
//    largest chunk that still gives ~one block an SM); the A chunk (64 rows,
//    M zero-padded to 64 in shared memory) and the B chunk stay in shared
//    memory for all repetitions, each as 128-byte-wide panels in the
//    128-byte swizzle wgmma reads (`wg_desc`), and every product reads them
//    there through the descriptors, so nothing is hoisted out of the loop;
//  * A arrives by TMA (one 64-row box a panel, zero-filled past M and K);
//    B (K, N) row-major is N-major, and an s8 wgmma takes only K-major
//    operands (an MN-major B exists for 16-bit types alone), so both types
//    stage B transposed: each thread loads EPW x EPW blocks of 4-byte words
//    (EPW = 4 / element bytes), transposes them with byte permutes and
//    stores them K-major, the lanes of a warp spread over 8 rows of
//    different swizzle phase and 4 depth words so the stores hit 32 banks;
//  * bf16: wgmma.m64n128k16 (fp32 sums); int8: wgmma.m64n128k32.s32.s8.s8
//    (int32 sums). As the original adds each grid step's `dot` into its
//    output block, each repetition's product goes to a fresh accumulator
//    (scale-d = 0 on its first k-step), and once its group completes it is
//    added into a running total: the tensor cores' internal sums never
//    run at the total's magnitude. Two warpgroups share the operand tiles
//    and alternate repetitions (even ones to warpgroup 0, odd ones to 1),
//    so one's wait and add overlap the other's products; their two totals
//    are added once at the end. (One warpgroup with two fresh accumulators
//    in turn makes ptxas serialize the wgmma groups: an accumulator it
//    sees written between the other's issue and wait.);
//  * K chunks (K = 4096 in five of the seven probe cases): each chunk's
//    tile goes to a partial buffer and `sum_chunks` adds them in chunk
//    order, a second pass with no atomics (none when K fits one chunk).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 128, NTH = 256;   // two warpgroups
constexpr int PANEL_A = BM * 128;   // bytes of a 128-byte-wide A panel
constexpr int PANEL_B = BN * 128;

struct Params {
  const unsigned char* b;   // (K, ldb) row-major, ldb x element bytes % 16 == 0
  void* out;                // (M, N) fp32 / int32, or partials (chunks, M, N)
  int M, N, K, ldb, reps;
};

// d = a . b (acc = 0) or d += a . b: m64n128k16, bf16 in, fp32 sums, both
// operands from shared memory (K-major)
__device__ __forceinline__ void wgmma_bf16(float* d, unsigned long long da,
                                           unsigned long long db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d = a . b (acc = 0) or d += a . b: m64n128k32, int8 in, int32 sums
__device__ __forceinline__ void wgmma_s8(int* d, unsigned long long da,
                                         unsigned long long db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// pins the accumulators after a wait: no access moves above it
template <typename T>
__device__ __forceinline__ void hold(T (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if constexpr (std::is_same_v<T, float>)
      asm volatile("" : "+f"(d[i])::"memory");
    else
      asm volatile("" : "+r"(d[i])::"memory");
  }
}

// the B chunk (depth k0 + [0, KCB / ES), columns n0 + [0, 128)) staged
// transposed: row n of the tile holds column n0 + n's depth, K-major in
// 128-byte panels (panel q: depth bytes [128 q, 128 q + 128)), 128-byte
// swizzled. A warp covers 8 column words x 4 depth words a step; lane (nl,
// kl) loads EPW depth rows of its column word and stores EPW column rows
// of its depth word, starting at row (nl / (8 / EPW)) % EPW of them, so a
// store instruction's 32 lanes hit 8 swizzle phases x 4 words: 32 banks.
template <int ES, int KCB>
__device__ __forceinline__ void stage_b(unsigned char* bs, const Params& p,
                                        int n0, int k0) {
  constexpr int EPW = 4 / ES, NWT = BN / EPW / 8, KWT = KCB / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nl = lane & 7, kl = lane >> 3, rot = nl / (8 / EPW);
#pragma unroll 4
  for (int t = warp; t < NWT * KWT; t += NTH / 32) {
    const int nw = (t % NWT) * 8 + nl, kw = (t / NWT) * 4 + kl;
    const int n = n0 + nw * EPW;
    unsigned in[EPW], o[EPW];
#pragma unroll
    for (int i = 0; i < EPW; ++i) {
      const int k = k0 + kw * EPW + i;
      in[i] = (k < p.K && n < p.ldb)
                  ? *reinterpret_cast<const unsigned*>(
                        p.b + ((long long)k * p.ldb + n) * ES)
                  : 0u;
    }
    if constexpr (EPW == 4) {
      const unsigned t0 = __byte_perm(in[0], in[1], 0x5140);
      const unsigned t1 = __byte_perm(in[2], in[3], 0x5140);
      const unsigned t2 = __byte_perm(in[0], in[1], 0x7362);
      const unsigned t3 = __byte_perm(in[2], in[3], 0x7362);
      o[0] = __byte_perm(t0, t1, 0x5410);
      o[1] = __byte_perm(t0, t1, 0x7632);
      o[2] = __byte_perm(t2, t3, 0x5410);
      o[3] = __byte_perm(t2, t3, 0x7632);
    } else {
      o[0] = __byte_perm(in[0], in[1], 0x5410);
      o[1] = __byte_perm(in[0], in[1], 0x7632);
    }
    const int kb = kw * 4, c = (kb & 127) >> 4;
    unsigned char* panel = bs + (kb >> 7) * PANEL_B + (kb & 15);
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      const int jj = (j + rot) % EPW;
      unsigned w = o[0];
#pragma unroll
      for (int x = 1; x < EPW; ++x) w = jj == x ? o[x] : w;
      const int r = nw * EPW + jj;
      *reinterpret_cast<unsigned*>(panel + r * 128 + ((c ^ (r & 7)) << 4)) = w;
    }
  }
}

template <bool I8, int KCB>
__global__ void __launch_bounds__(NTH, 1)
    mm_rep(const __grid_constant__ CUtensorMap amap, Params p) {
  using Acc = std::conditional_t<I8, int, float>;
  constexpr int ES = I8 ? 1 : 2, NP = KCB / 128, KS = KCB / 32;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long bar;
  unsigned char* as =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bs = as + NP * PANEL_A;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k0 = blockIdx.z * (KCB / ES);
  if (tid == 0) {
    mbar_init(&bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bar, NP * PANEL_A);
#pragma unroll
    for (int q = 0; q < NP; ++q)
      tma_load(as + q * PANEL_A, &amap, k0 + q * (128 / ES), m0, &bar);
  }
  stage_b<ES, KCB>(bs, p, n0, k0);
  // the generic-proxy stores of B, before wgmma (async proxy) reads them
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  mbar_wait(&bar, 0);

  const int wg = tid >> 7, t = tid & 127;
  auto issue = [&](Acc (&f)[64]) {
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int off = (ks & 3) * 32;   // 32 bytes of depth a k-step
      const unsigned long long da = wg_desc(as + (ks >> 2) * PANEL_A + off);
      const unsigned long long db = wg_desc(bs + (ks >> 2) * PANEL_B + off);
      if constexpr (I8)
        wgmma_s8(f, da, db, ks > 0);
      else
        wgmma_bf16(f, da, db, ks > 0);
    }
    wg_commit();
  };
  // warpgroup wg takes repetitions wg, wg + 2, ...: while one waits for
  // its group and adds it, the other's group runs
  Acc tot[64], f[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] = f[i] = 0;
  for (int r = wg; r < p.reps; r += 2) {
    issue(f);
    wg_wait<0>();
    hold(f);
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] += f[i];
  }

  // warpgroup 1's total joins warpgroup 0's through shared memory (the
  // operand tiles are no longer read), element i of thread t at [i][t]
  __syncthreads();
  Acc* x = reinterpret_cast<Acc*>(as);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 64; ++i) x[i * 128 + t] = tot[i];
  }
  __syncthreads();
  if (wg == 1) return;
  // element 4 i + e of a thread's tile: row 16 warp + g + 8 (e / 2),
  // column 8 i + 2 t4 + e % 2 (the wgmma accumulator layout)
  const int warp = t >> 5, g = (t & 31) >> 2, t4 = t & 3;
  Acc* out = static_cast<Acc*>(p.out) + (long long)blockIdx.z * p.M * p.N;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int m = m0 + 16 * warp + g + 8 * ((j >> 1) & 1);
    const int n = n0 + 8 * (j >> 2) + 2 * t4 + (j & 1);
    if (m < p.M && n < p.N) out[(long long)m * p.N + n] = tot[j] + x[j * 128 + t];
  }
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

// the operand panels, or the 64 x 128 total warpgroup 1 hands over if more
constexpr int smem_bytes(int kcb) {
  return 1024 + (kcb / 128 * (PANEL_A + PANEL_B) > BM * BN * 4
                     ? kcb / 128 * (PANEL_A + PANEL_B)
                     : BM * BN * 4);
}

template <bool I8, int KCB>
cudaError_t launch_rep(const CUtensorMap& amap, const Params& p, int chunks,
                       cudaStream_t st) {
  constexpr int smem = smem_bytes(KCB);
  static const cudaError_t attr = cudaFuncSetAttribute(
      mm_rep<I8, KCB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, chunks);
  mm_rep<I8, KCB><<<grid, NTH, smem, st>>>(amap, p);
  return cudaGetLastError();
}

template <bool I8>
cudaError_t launch_kcb(int kcb, const CUtensorMap& amap, const Params& p,
                       int chunks, cudaStream_t st) {
  switch (kcb) {
    case 128: return launch_rep<I8, 128>(amap, p, chunks, st);
    case 256: return launch_rep<I8, 256>(amap, p, chunks, st);
    default: return launch_rep<I8, 512>(amap, p, chunks, st);
  }
}

}  // namespace

// a (M, K) and b (K, ldb) row-major contiguous, bf16 (i8 = 0) or int8
// (i8 = 1), K and ldb a multiple of 16 bytes of elements, 16-byte aligned,
// N <= ldb; out (M, N) fp32 or int32 contiguous; part (chunks, M, N) of
// out's type when chunks = ceil(K x element bytes / kcb) > 1, else unused.
// kcb: 128, 256 or 512 (bytes of depth a chunk). reps: the repetitions
// (ops/mm_probe.py's REPS). Returns a cudaError_t (0 = launched; an invalid
// value also when the tensor map cannot be made).
extern "C" int gill_mm_probe(const void* a, const void* b, void* out,
                             void* part, int i8, int M, int N, int K,
                             int ldb, int kcb, int reps, void* stream) {
  const int es = i8 ? 1 : 2;
  if (M <= 0 || N <= 0 || K <= 0 || reps <= 0 || N > ldb ||
      (kcb != 128 && kcb != 256 && kcb != 512) || (K * es) % 16 ||
      (ldb * es) % 16 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16)
    return (int)cudaErrorInvalidValue;
  const long long chunks = ((long long)K * es + kcb - 1) / kcb;
  if (chunks > 65535 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap amap;
  if (!tensor_map_2d(&amap, i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     a, M, K, (unsigned long long)K * es, BM, 128 / es,
                     CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const unsigned char*>(b), chunks > 1 ? part : out, M, N,
           K, ldb, reps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = i8 ? launch_kcb<true>(kcb, amap, p, (int)chunks, st)
                     : launch_kcb<false>(kcb, amap, p, (int)chunks, st);
  if (e != cudaSuccess || chunks == 1) return (int)e;
  const long long n = (long long)M * N;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  if (i8)
    sum_chunks_i32<<<blocks, 256, 0, st>>>(static_cast<const int*>(part),
                                           static_cast<int*>(out), n,
                                           (int)chunks);
  else
    sum_chunks_f32<<<blocks, 256, 0, st>>>(static_cast<const float*>(part),
                                           static_cast<float*>(out), n,
                                           (int)chunks);
  return (int)cudaGetLastError();
}
