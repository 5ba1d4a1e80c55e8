// GEGLU feed-forward for Hopper (sm_90a), bf16 in and out:
//   out = (gelu(x Wg + bg) * (x Wv + bv)) W2 + b2,
// w1 (d, 8d) packing [val | gate] column halves, w2 (4d, d), the EXACT erf
// gelu of the composed path (diffusers GEGLU; gill_tpu models/sd/unet.py
// `_geglu_ff`), not the Pallas kernels' tanh form (Mosaic lacks erf).
//
// K3 replaces gill_tpu/ops/geglu.py `geglu_ff` (Pallas body `_kernel`) as
// two GEMMs with fused epilogues:
//  * `geglu_up_wg`: h = bf16((x Wv + bv) * gelu(x Wg + bg)), an (M, 4d)
//    intermediate rounded to bf16 once, where the Pallas kernel rounds it
//    (`h.astype(x.dtype)`) before its second product;
//  * `geglu_down_wg`: out = bf16(h W2 + b2), fp32 sums, b2 added in fp32.
// What bounds it on an H100: 24 M d^2 flops on the bf16 tensor cores,
// 0.020 ms at 989 TFLOP/s for M d^2 = 8192 x 320^2, 2048 x 640^2 and
// 512 x 1280^2; at M 128, d 1280 the 39 MB of W1 and W2 (0.012 ms at
// 3.35 TB/s). A fused kernel (K9's design below) keeps the (BM, d) output in
// registers, which caps its row tile at 20480 / d rows, and feeds WMMA
// from per-thread copies. The design:
//  * wgmma, the only path to the card's full tensor rate: one warpgroup a
//    block computes 64 weight columns by 128 rows (m64n128k16, fp32 sums
//    in registers) a product, twice in `geglu_up_wg` (the val and the gate
//    columns of the same 64 columns of h) and once or twice in
//    `geglu_down_wg` (64 or 128 output columns). The operands are swapped
//    (h^T = W^T x^T): the activations, K-major, are wgmma's shared B
//    operand, and the row-major weights, which wgmma would take only
//    transposed from shared memory, reach its register A operand through
//    ldmatrix.trans;
//  * TMA copies the 128 x 64 activation tile and the 64 x 64 weight boxes
//    of each 64-deep step into a 3-stage ring, 128-byte swizzled (so the
//    wgmma descriptor and ldmatrix both read without bank conflicts), one
//    mbarrier a stage; one thread starts them once a block barrier shows
//    the stage read. The same GEMMs on mma.sync fed by per-thread 16-byte
//    cp.async ran 1.5-2.8x slower at the four UNet shapes (timed by
//    chip_smoke.py, PERF.md);
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
// GILL_SD_FUSE_LN=1) with one fused kernel: one block = BM rows of x
// and all d output columns, 8 warps, the (BM, d) fp32 output accumulator
// in WMMA fragments (BM * d = 20480, so BM = 64 / 32 / 16 at d = 320 /
// 640 / 1280); x is the raw residual stream and the block normalizes its
// resident x tile in place (common.cuh `ln_rows_inplace`, `_ln_rows`'
// rounding points) before the first product; the inner 4d dimension is
// walked in chunks of 64 whose gated values are contracted at once into
// the output fragments over double-buffered W1 / W2 tiles; when M / BM
// blocks cannot fill the SMs, grid.y splits the chunks and `geglu_reduce`
// sums the fp32 partials in a fixed order.

#include <mma.h>

#include <initializer_list>

#include "common.cuh"

namespace {

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// K3: two GEMMs on wgmma, D (64, 128) += A (64, 16) B (16, 128), A (the
// weights) from registers, B (128 activation rows, 16 deep) from shared
// memory, both fed by TMA
// ---------------------------------------------------------------------------

// a (BM, NCOL) bf16 tile staged in shared memory (row stride NCOL + 8)
// out to rows m0 + [0, BM) (below M) and columns c0 + [0, NCOL) of a
// row-major matrix with ld columns, 16 bytes a store
template <int BM, int NCOL, int NTH>
__device__ __forceinline__ void store_tile(const bf16* st, bf16* out, int ld,
                                           int m0, int c0, int M) {
  constexpr int NCH = NCOL / 8, LO = NCOL + 8;
  for (int i = threadIdx.x; i < BM * NCH; i += NTH) {
    const int r = i / NCH, c = i % NCH;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(out + (long long)(m0 + r) * ld + c0 + 8 * c) =
          *reinterpret_cast<const uint4*>(st + r * LO + 8 * c);
  }
}


__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma
__device__ __forceinline__ void wg_hold(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += a . b: m64n128k16, bf16 in, fp32 sums
__device__ __forceinline__ void wgmma_128(float* d, const unsigned* a,
                                          unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

constexpr int WG_BM = 128, WG_BK = 64, WG_ST = 3;
constexpr int WG_X_BYTES = WG_BM * WG_BK * 2;   // 128 rows of 128 bytes
constexpr int WG_W_BYTES = WG_BK * 64 * 2;      // one 64 x 64 weight box

template <int NX> struct WgSmem {
  static constexpr int STAGE = WG_X_BYTES + NX * WG_W_BYTES;
  // + 1024 to align the ring to the 1024-byte swizzle atoms, + barriers
  static constexpr int BYTES = 1024 + WG_ST * STAGE + WG_ST * 8;
};

// the activation tile of a stage as the wgmma B operand: 128-byte
// swizzled K-major rows, 8-row atoms 1024 bytes apart; k16 step ks starts
// 32 ks bytes into the atom
__device__ __forceinline__ unsigned long long wg_desc(const void* p) {
  return (unsigned long long)((smem_u32(p) & 0x3FFFF) >> 4) |
         (1ull << 16) | ((unsigned long long)(1024 >> 4) << 32) |
         (1ull << 62);
}

// the (64 NX weight columns, 128 rows) product over depth tiles [t0, t1):
// activations (map xa, rows m0 + [0, 128), TMA zero-fills rows past M)
// and NX 64-column weight boxes (map wa, columns col[j]) per 64-deep tile
// through a WG_ST-stage ring; thread 0 starts a stage's copies once the
// block barrier shows its previous contents read. The weights go through
// ldmatrix.trans into wgmma's register A fragments (warp w: weight
// columns 16 w + [0, 16) of each box), the activations are its shared B
// operand: acc[j] holds the box-j product, element 4 i + e at (weight
// column 16 w + g + 8 (e / 2), row 8 i + 2 t4 + e % 2).
template <int NX>
__device__ __forceinline__ void wg_gemm(float (&acc)[NX][64],
                                        unsigned char* smem_raw,
                                        const CUtensorMap* xa,
                                        const CUtensorMap* wa, int m0,
                                        const int (&col)[NX], int t0,
                                        int t1) {
  using S = WgSmem<NX>;
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + WG_ST * S::STAGE);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mi = lane >> 3, mr = lane & 7;
  const int nt = t1 - t0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_ST; ++s) mbar_init(full + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto fill = [&](int t) {
    unsigned char* st = ring + (t % WG_ST) * S::STAGE;
    mbar_expect(full + t % WG_ST, S::STAGE);
    const int k0 = (t0 + t) * WG_BK;
    tma_load(st, xa, k0, m0, full + t % WG_ST);
#pragma unroll
    for (int j = 0; j < NX; ++j)
      tma_load(st + WG_X_BYTES + j * WG_W_BYTES, wa, col[j], k0,
               full + t % WG_ST);
  };
  if (threadIdx.x == 0)
    for (int t = 0; t < WG_ST - 1 && t < nt; ++t) fill(t);
#pragma unroll
  for (int j = 0; j < NX; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;
  for (int t = 0; t < nt; ++t) {
    // every warp is done with tile t - 1: its stage may be refilled
    __syncthreads();
    if (threadIdx.x == 0 && t + WG_ST - 1 < nt) fill(t + WG_ST - 1);
    mbar_wait(full + t % WG_ST, (t / WG_ST) & 1);
    const unsigned char* st = ring + (t % WG_ST) * S::STAGE;
    unsigned af[NX][WG_BK / 16][4];
#pragma unroll
    for (int j = 0; j < NX; ++j)
#pragma unroll
      for (int ks = 0; ks < WG_BK / 16; ++ks) {
        // box j is 64 rows (depth) of 128 swizzled bytes: chunk c of row
        // r sits at chunk c ^ (r % 8)
        const int r = ks * 16 + (mi >> 1) * 8 + mr;
        const int c = 2 * warp + (mi & 1);
        ldsm_x4_t(af[j][ks], st + WG_X_BYTES + j * WG_W_BYTES + r * 128 +
                                 ((c ^ (r & 7)) << 4));
      }
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < WG_BK / 16; ++ks) {
      const unsigned long long desc = wg_desc(st + 32 * ks);
#pragma unroll
      for (int j = 0; j < NX; ++j) wgmma_128(acc[j], af[j][ks], desc);
    }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int j = 0; j < NX; ++j) wg_hold(acc[j]);
  }
  __syncthreads();                    // the ring is free for the epilogue
}

// h (M, 4d) = bf16((x Wv + bv) * gelu(x Wg + bg)) for 64 columns [n0, n0
// + 64) of h and 128 rows a block: acc[0] the val columns, acc[1] the gate
// columns
__global__ void __launch_bounds__(128)
    geglu_up_wg(const __grid_constant__ CUtensorMap xa,
                const __grid_constant__ CUtensorMap wa,
                const bf16* __restrict__ b1, bf16* __restrict__ h, int M,
                int d) {
  constexpr int LO = 64 + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int inner = 4 * d, n0 = blockIdx.x * 64, m0 = blockIdx.y * WG_BM;
  float acc[2][64];
  const int col[2] = {n0, inner + n0};
  wg_gemm<2>(acc, smem, &xa, &wa, m0, col, 0, d / WG_BK);
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
  int col[NX];
#pragma unroll
  for (int j = 0; j < NX; ++j) col[j] = c0 + 64 * j;
  wg_gemm<NX>(acc, smem, &ha, &wa, m0, col, z * nk / splits,
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

// ---------------------------------------------------------------------------
// K9: the LN-folded fused kernel
// ---------------------------------------------------------------------------

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

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

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

template <int D>
__global__ void __launch_bounds__(NT)
    geglu_ln_fwd(const bf16* __restrict__ x, const bf16* __restrict__ ln_g,
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
  // the rows are written; the first barrier of the loop below orders the
  // normalized tile before any product reads it
  __syncthreads();
  ln_rows_inplace<D>(xs, C::LX, BM, ln_g, ln_b, ln_eps, warp, NW, lane);

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

template <int D>
cudaError_t launch_ln(const void* x, const void* ln_g, const void* ln_b,
                      float ln_eps, const void* w1, const void* b1,
                      const void* w2, const void* b2, void* out, void* ws,
                      int M, int splits, cudaStream_t stream) {
  constexpr size_t smem = GSmem<D>::total;
  static const cudaError_t attr = cudaFuncSetAttribute(
      geglu_ln_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(row_blocks<D>(M), splits);
  geglu_ln_fwd<D><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln_g),
      static_cast<const bf16*>(ln_b), ln_eps, static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out),
      static_cast<float*>(ws), M);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return reduce_splits(ws, b2, out, M, D, splits, stream);
}

// a 2-D tensor map over a row-major bf16 (rows, cols) matrix, boxes of
// (box_rows, 64) elements, 128-byte swizzled; false if it cannot be made
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols,
                int box_rows) {
  return tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rows,
                       cols, 2ull * cols, box_rows, 64,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

cudaError_t launch_up_wg(const void* x, const void* w1, const void* b1,
                         void* h, int M, int d, cudaStream_t stream) {
  CUtensorMap xa, wa;
  if (!tensor_map(&xa, x, M, d, WG_BM) || !tensor_map(&wa, w1, d, 8 * d, 64))
    return cudaErrorInvalidValue;
  constexpr int smem = WgSmem<2>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      geglu_up_wg, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(4 * d / 64, (M + WG_BM - 1) / WG_BM);
  geglu_up_wg<<<grid, 128, smem, stream>>>(
      xa, wa, static_cast<const bf16*>(b1), static_cast<bf16*>(h), M, d);
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

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

}  // namespace

// K3. All tensors bf16, contiguous, 16-byte aligned: x (M, d), w1 (d, 8d),
// b1 (8d), w2 (4d, d), b2 (d), h (M, 4d) scratch, out (M, d); d in {320,
// 640, 1280}; down_bn (`geglu_down_wg`'s columns a block) 64 or 128,
// dividing d; splits in [1, 4d / 64], with ws a float32 (splits, M, d)
// workspace when above 1 (`ops/geglu.py` `geglu_plan`). Returns a
// cudaError_t (0 = launched; an invalid value also when a tensor map cannot
// be made).
extern "C" int gill_geglu_ff(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* h,
                             void* out, void* ws, int M, int d, int down_bn,
                             int splits, void* stream) {
  if (M <= 0 || (d != 320 && d != 640 && d != 1280) || splits < 1 ||
      splits > 4 * d / WG_BK || (splits > 1 && ws == nullptr) ||
      (down_bn != 64 && down_bn != 128) || d % down_bn)
    return (int)cudaErrorInvalidValue;
  if (!aligned16({x, w1, b1, w2, b2, h, out, ws}))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_up_wg(x, w1, b1, h, M, d, st);
  if (e != cudaSuccess) return (int)e;
  return (int)(down_bn == 128
                   ? launch_down_wg<2>(h, w2, b2, out, ws, M, d, splits, st)
                   : launch_down_wg<1>(h, w2, b2, out, ws, M, d, splits, st));
}

// K9: gill_geglu_ff on LN(x), one fused launch (plus the split-sum): ln_g
// and ln_b bf16 (d), ln_eps the LayerNorm's epsilon, x the raw input; x,
// w1, b1, w2, b2, out as above; splits in [1, 4d / 64] (`ops/geglu.py`
// `geglu_ln_splits`), ws a float32 (splits, M, d) workspace when above 1.
// Returns a cudaError_t.
extern "C" int gill_geglu_ff_ln(const void* x, const void* ln_g,
                                const void* ln_b, float ln_eps, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                void* out, void* ws, int M, int d, int splits,
                                void* stream) {
  if (M <= 0 || splits < 1 || splits > 4 * d / NC ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 320:
      return (int)launch_ln<320>(x, ln_g, ln_b, ln_eps, w1, b1, w2, b2, out,
                                 ws, M, splits, st);
    case 640:
      return (int)launch_ln<640>(x, ln_g, ln_b, ln_eps, w1, b1, w2, b2, out,
                                 ws, M, splits, st);
    case 1280:
      return (int)launch_ln<1280>(x, ln_g, ln_b, ln_eps, w1, b1, w2, b2, out,
                                  ws, M, splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
