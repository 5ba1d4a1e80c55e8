// The TMA-fed wgmma GEMM core of the GEGLU feed-forward (K3), shared by
// csrc/geglu.cu and csrc/ln_matmul.cu, and the LayerNorm pieces that put
// the LN-folded kernels (K7-K9) on it: a row-statistics pre-pass
// (`ln_stats`) and a prologue (`LnTile`) that normalizes each activation
// tile in shared memory before the tensor cores read it.
//
// `wg_gemm`: one warpgroup a block computes the product of 64 NX weight
// columns by 128 activation rows (m64n128k16, fp32 sums in registers). The
// operands are swapped (y^T = W^T x^T): the activations, K-major, are
// wgmma's shared B operand, and the row-major weights, which wgmma would
// take only transposed from shared memory, reach its register A operand
// through ldmatrix.trans. TMA copies the 128 x 64 activation tile and the
// 64 x 64 weight boxes of each 64-deep step into a 3-stage ring, 128-byte
// swizzled (so the wgmma descriptor and ldmatrix both read without bank
// conflicts), one mbarrier a stage; one thread starts a stage's copies
// once a block barrier shows the stage read.
//
// The prologue hook (a compile-time parameter): K3 instantiates the core
// with `NoPrologue`, and its loop is the one it always had. With `LnTile`
// the block normalizes tile t + 1 in shared memory while the tensor cores
// run tile t's asynchronous wgmma group, so the normalized (M, d) tensor
// never exists in device memory; the statistics come from `ln_stats`,
// launched just before (M x 8 bytes), so x is read once for them rather
// than once per column block.

#pragma once

#include <initializer_list>
#include <type_traits>
#include <utility>

#include "common.cuh"

namespace {

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void wg_hold(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// d += a . b: m64n64k16, bf16 in, fp32 sums (64-row activation tiles)
__device__ __forceinline__ void wgmma_64(float* d, const unsigned* a,
                                         unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// activation rows a block (K3's; the LN-matmul also takes 64), depth a
// stage, stages
constexpr int WG_BM = 128, WG_BK = 64, WG_ST = 3;
constexpr int WG_W_BYTES = WG_BK * 64 * 2;      // one 64 x 64 weight box

// the ring's barriers, padded to 16 bytes: a prologue's own shared memory
// follows them
constexpr int WG_BAR_BYTES = (WG_ST * 8 + 15) / 16 * 16;

template <int NX, int BM = WG_BM> struct WgSmem {
  static constexpr int X_BYTES = BM * WG_BK * 2;  // BM rows of 128 bytes
  static constexpr int STAGE = X_BYTES + NX * WG_W_BYTES;
  // + 1024 to align the ring to the 1024-byte swizzle atoms, + barriers
  static constexpr int BYTES = 1024 + WG_ST * STAGE + WG_ST * 8;
};

// a (BM, NCOL) bf16 tile staged in shared memory (row stride LO) out to
// rows m0 + [0, BM) (below M) and columns c0 + [0, NCOL) of a row-major
// matrix with ld columns, 16 bytes a store
template <int BM, int NCOL, int NTH, int LO = NCOL + 8>
__device__ __forceinline__ void store_tile(const bf16* st, bf16* out, int ld,
                                           int m0, int c0, int M) {
  constexpr int NCH = NCOL / 8;
  for (int i = threadIdx.x; i < BM * NCH; i += NTH) {
    const int r = i / NCH, c = i % NCH;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(out + (long long)(m0 + r) * ld + c0 + 8 * c) =
          *reinterpret_cast<const uint4*>(st + r * LO + 8 * c);
  }
}

// the core's hook with nothing to do: the activation tile goes to the
// tensor cores as TMA delivered it (K3)
struct NoPrologue {
  static constexpr bool active = false;
};

// the (64 NX weight columns, BM rows) product over depth tiles [t0, t1):
// activations (map xa, boxes of BM rows: rows m0 + [0, BM), TMA zero-fills
// rows past M)
// and NX 64-column weight boxes (map wa, box j at column wcol[j] and rows
// wrow[j] + the depth) per 64-deep tile through a WG_ST-stage ring; thread
// 0 starts a stage's copies once the block barrier shows its previous
// contents read. The weights go through ldmatrix.trans into wgmma's
// register A fragments (warp w: weight columns 16 w + [0, 16) of each
// box), the activations are its shared B operand (m64n128k16 at BM 128,
// m64n64k16 at 64): acc[j] holds the box-j product, element 4 i + e at
// (weight column 16 w + g + 8 (e / 2), row 8 i + 2 t4 + e % 2).
//
// An active prologue `pro` first gets pro.begin(m0, extra), after the
// first stages' copies are started (`extra`: 16-byte aligned shared memory
// past the ring's barriers, the prologue's own bytes, which the launch
// adds to WgSmem<NX, BM>::BYTES), then pro(tile, t) for each depth tile t,
// whose activations it may rewrite in place (ending with a proxy fence):
// tile t0 before the loop, tile t + 1 while tile t's wgmma group runs. The
// loop's block barrier orders those writes before the group that reads
// them, and before the copy that next refills their stage.
template <int NX, int BM = WG_BM, class Pro = NoPrologue>
__device__ __forceinline__ void wg_gemm(float (&acc)[NX][BM / 2],
                                        unsigned char* smem_raw,
                                        const CUtensorMap* xa,
                                        const CUtensorMap* wa, int m0,
                                        const int (&wcol)[NX],
                                        const int (&wrow)[NX], int t0,
                                        int t1, Pro&& pro = Pro()) {
  static_assert(BM == 64 || BM == 128, "row tile");
  using S = WgSmem<NX, BM>;
  constexpr bool LN = std::decay_t<Pro>::active;
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
      tma_load(st + S::X_BYTES + j * WG_W_BYTES, wa, wcol[j], wrow[j] + k0,
               full + t % WG_ST);
  };
  if (threadIdx.x == 0)
    for (int t = 0; t < WG_ST - 1 && t < nt; ++t) fill(t);
#pragma unroll
  for (int j = 0; j < NX; ++j)
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[j][i] = 0.f;
  if constexpr (LN) {
    pro.begin(m0, ring + WG_ST * S::STAGE + WG_BAR_BYTES);
    if (nt > 0) {
      mbar_wait(full, 0);
      pro(ring, t0);
    }
  }
  for (int t = 0; t < nt; ++t) {
    // every warp is done with tile t - 1: its stage may be refilled
    __syncthreads();
    if (threadIdx.x == 0 && t + WG_ST - 1 < nt) fill(t + WG_ST - 1);
    if constexpr (!LN) mbar_wait(full + t % WG_ST, (t / WG_ST) & 1);
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
        ldsm_x4_t(af[j][ks], st + S::X_BYTES + j * WG_W_BYTES + r * 128 +
                                 ((c ^ (r & 7)) << 4));
      }
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < WG_BK / 16; ++ks) {
      // the activation tile of the stage as the wgmma B operand; k16 step
      // ks starts 32 ks bytes into its 128-byte rows
      const unsigned long long desc = wg_desc(st + 32 * ks);
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        if constexpr (BM == 128)
          wgmma_128(acc[j], af[j][ks], desc);
        else
          wgmma_64(acc[j], af[j][ks], desc);
      }
    }
    wg_commit();
    if constexpr (LN) {
      if (t + 1 < nt) {
        mbar_wait(full + (t + 1) % WG_ST, ((t + 1) / WG_ST) & 1);
        pro(ring + ((t + 1) % WG_ST) * S::STAGE, t0 + t + 1);
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int j = 0; j < NX; ++j) wg_hold<BM / 2>(acc[j]);
  }
  __syncthreads();                    // the ring is free for the epilogue
}

// every pointer 16-byte aligned (a null one passes)
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// a 2-D tensor map over a row-major bf16 (rows, cols) matrix, boxes of
// (box_rows, 64) elements, 128-byte swizzled; false if it cannot be made
inline bool tensor_map(CUtensorMap* map, const void* base, int rows,
                       int cols, int box_rows) {
  return tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rows,
                       cols, 2ull * cols, box_rows, 64,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---------------------------------------------------------------------------
// LayerNorm with the rounding points of gill_tpu/ops/ln_matmul.py
// `_ln_rows`: mean and E[x^2] of the fp32 x (squared in fp32), the
// variance clamped at 0, inv = rsqrt(var + eps), a = bf16(inv * gamma),
// sh = bf16(beta - mean * inv * gamma), then bf16(bf16(x * a) + sh). The
// _rn intrinsics keep the compiler from contracting products into fused
// multiply-adds the reference does not make.
// ---------------------------------------------------------------------------

// (mean, inv) of one bf16 row of width d (a multiple of 8, 16-byte aligned
// row), one warp: lane-strided fp32 sums of 16-byte chunks, then a
// butterfly, so the order depends on d alone
__device__ __forceinline__ float2 ln_row_stats(const bf16* __restrict__ row,
                                               int d, float eps, int lane) {
  float s = 0.f, s2 = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = __bfloat162float(e[j]);
      s = __fadd_rn(s, f);
      s2 = __fadd_rn(s2, __fmul_rn(f, f));
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = __fdiv_rn(s, (float)d);
  const float mean2 = __fdiv_rn(s2, (float)d);
  const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
  return make_float2(mean, __frsqrt_rn(__fadd_rn(var, eps)));
}

// bf16x2 products and sums, each rounded once: x and a are bf16, so the
// fp32 product is exact and one rounding equals the reference's two; a
// bf16 sum is exact in fp32 unless the exponents differ by more than 15,
// and then the fp32 rounding cannot reach a bf16 rounding boundary
__device__ __forceinline__ unsigned bf2_mul(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf2_add(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// one 16-byte chunk (8 bf16) of a row normalized: gamma and beta the
// chunk's 8 columns, inv and mi = mean * inv the row's statistics
__device__ __forceinline__ uint4 ln_apply8(uint4 x, uint4 gamma, uint4 beta,
                                           float inv, float mi) {
  const unsigned* xv = reinterpret_cast<const unsigned*>(&x);
  const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(&gamma);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&beta);
  uint4 out;
  unsigned* o = reinterpret_cast<unsigned*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 gf = __bfloat1622float2(g[j]), bf = __bfloat1622float2(b[j]);
    const unsigned a = pack_bf16(__fmul_rn(inv, gf.x), __fmul_rn(inv, gf.y));
    const unsigned sh = pack_bf16(__fsub_rn(bf.x, __fmul_rn(mi, gf.x)),
                                  __fsub_rn(bf.y, __fmul_rn(mi, gf.y)));
    o[j] = bf2_add(bf2_mul(xv[j], a), sh);
  }
  return out;
}

// stats[r] = (mean, inv) of row r of x (M, d), one warp a row. The next
// kernel on the stream (launched with `launch_dependent`) may start its
// set-up and its first copies at once; it waits for these writes before
// it reads them.
__global__ void __launch_bounds__(256)
    ln_stats(const bf16* __restrict__ x, float2* __restrict__ stats, int M,
             int d, float eps) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const float2 st = ln_row_stats(x + (long long)row * d, d, eps, lane);
  if (lane == 0) stats[row] = st;
}

inline cudaError_t launch_ln_stats(const void* x, void* stats, int M, int d,
                                   float eps, cudaStream_t stream) {
  ln_stats<<<(M + 7) / 8, 256, 0, stream>>>(static_cast<const bf16*>(x),
                                             static_cast<float2*>(stats), M,
                                             d, eps);
  return cudaGetLastError();
}

// a launch that may begin while the kernel before it on the stream
// finishes (programmatic dependent launch); the kernel must execute
// griddepcontrol.wait before it reads what that kernel writes
template <class... P, class... A>
cudaError_t launch_dependent(void (*kernel)(P...), dim3 grid, int threads,
                             int smem, cudaStream_t stream, A&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The LayerNorm prologue of `wg_gemm`: normalizes a stage's (BM, 64)
// activation tile in shared memory, with `ln_stats`' statistics, in place.
// Thread i takes physical 16-byte chunk i % 8 of rows i / 8 + 16 r (r <
// BM / 16): in the 128-byte swizzle that is logical chunk (i % 8) ^ (i / 8
// % 8) of every one of its rows, so its 8 gamma and beta columns are the
// same for all of them, and a warp's accesses cover 512 contiguous bytes.
// Rows past M (zero-filled by TMA) take mean 0 and inv 0 and normalize to
// beta; they are never stored.
template <int BM = WG_BM>
struct LnTile {
  static constexpr bool active = true;
  static constexpr int R = BM / 16;      // rows a thread
  const float2* stats;
  const bf16* gamma;
  const bf16* beta;
  int M, d;
  const bf16* gb;         // gamma, then beta, in shared memory
  float inv[R], mi[R];

  // copies gamma and beta into `extra` (smem_bytes(d)), waits for
  // `ln_stats` (the kernel before on the stream), then loads the
  // statistics of this thread's rows; ends with a block barrier
  __device__ void begin(int m0, unsigned char* extra) {
    uint4* dst = reinterpret_cast<uint4*>(extra);
    for (int i = threadIdx.x; i < d / 8; i += 128) {
      dst[i] = reinterpret_cast<const uint4*>(gamma)[i];
      dst[d / 8 + i] = reinterpret_cast<const uint4*>(beta)[i];
    }
    gb = reinterpret_cast<const bf16*>(extra);
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = m0 + (threadIdx.x >> 3) + 16 * r;
      const float2 s = row < M ? stats[row] : make_float2(0.f, 0.f);
      inv[r] = s.y;
      mi[r] = __fmul_rn(s.x, s.y);
    }
    __syncthreads();
  }
  // the shared memory the prologue adds to the ring's
  static constexpr int smem_bytes(int d) {
    return WG_BAR_BYTES - WG_ST * 8 + 4 * d;
  }

  __device__ void operator()(unsigned char* tile, int t) {
    const int p = threadIdx.x & 7, r0 = threadIdx.x >> 3;
    const int col = t * WG_BK + 8 * (p ^ (r0 & 7));
    const uint4 g = *reinterpret_cast<const uint4*>(gb + col);
    const uint4 b = *reinterpret_cast<const uint4*>(gb + d + col);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint4* q = reinterpret_cast<uint4*>(tile + (r0 + 16 * r) * 128 + 16 * p);
      *q = ln_apply8(*q, g, b, inv[r], mi[r]);
    }
    // the generic-proxy writes, before the async proxy (wgmma, the next
    // TMA refill of the stage) touches the tile
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
};

}  // namespace
