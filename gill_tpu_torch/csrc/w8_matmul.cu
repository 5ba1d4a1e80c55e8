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
// would bound it; one OPT-6.7B decode step streams 6.44 GB of int8 weights,
// >= 1.92 ms at 3.35 TB/s, and every call finds its layer's weights out of
// the 50 MB L2. The design keeps that stream moving:
//  * one block = a strip of BN (64 or 128) output columns over a range of
//    K, one launch a call. One producer warp keeps a ring of `stages`
//    stages in flight (~96 KB), each a (KT x BN) int8 weight box and the
//    matching (rows x KT) x boxes, by TMA (`cp.async.bulk.tensor`, 128- or
//    64-byte swizzled, one "full" mbarrier a stage); eight consumer warps
//    read a stage and release it on its "empty" mbarrier, with no
//    block-wide barrier in the loop;
//  * the weights are widened in registers, never in shared memory: a
//    consumer thread reads BN / 8 bytes of each of four K rows with one
//    load (conflict-free under the swizzle), pairs rows 2 t and 2 t + 1
//    byte by byte with one byte permute a pair, and makes each pair bf16
//    with two masks and one bf16x2 add (a byte l - 128 s is (128 + l) -
//    (128 + 128 s), both halves exact in bf16), then feeds mma.sync
//    m16n8k16 (bf16, fp32 sums) with swapped operands, y^T = W^T x^T: the
//    widened weights are the A operand (16 output columns x 16 of K), x^T
//    from ldmatrix the B operand (one n8 tile for M <= 8, two for M <= 16).
//    The A fragment wants pairs along K while the weight tile has N
//    contiguous, so inside a strip the A row r of n-tile j is output
//    column (r % 8) * BN / 8 + 2 j + r / 8: each thread's columns are
//    contiguous bytes, and the epilogue undoes the permutation;
//  * at M <= 16 the eight warps take eighths of each stage's K rows over
//    one x tile of 8 or 16 rows; at M > 16 (prefill waves) a 128-row x
//    tile, each warp 32 of its rows (four n8 tiles, so every widened A
//    fragment feeds four products) over half of the stage's K rows,
//    at one plan for every M from 17 to 256 (the K split of one row
//    block); `ops/w8_matmul.py` `w8_matmul_rows` takes longer products as
//    256-row windows, so a prefill row's bits do not follow its wave's
//    size;
//  * fp32 x (the sequential decode, M = 1): exact fp32 FMA on the CUDA
//    cores on the same ring, each lane four adjacent columns, the weights
//    widened through fp32 (2^23 + u - (2^23 + 128));
//  * where the strips are too few to fill the SMs (N 4096), K is split
//    over the blocks of a thread-block cluster (2-8); each block sums its
//    warps' partials in shared memory in a fixed order, and after a
//    cluster barrier block r adds the cluster's partials for its share of
//    the strip's columns, in rank order, over distributed shared memory.
//    No workspace, no second kernel, and the result is the same bit for
//    bit run to run;
//  * programmatic dependent launch: the set-up (barriers, tensor-map
//    prefetch) overlaps the previous kernel's tail, every thread waits on
//    `griddepcontrol.wait` before it reads global memory, and the next
//    kernel may start its own set-up once this one's K loop is done;
//  * the wrapper's plan (`ops/w8_matmul.py` `w8_plan`) must equal this
//    file's `plan_for`, or the launch is refused.
// What holds it back at 4096 x 4096 (16.8 MB, a 5 us byte bound): a fixed
// cost of several microseconds a call (launch, the first loads' latency,
// the epilogue and cluster barriers) that the stream cannot hide.

#include <cooperative_groups.h>

#include <initializer_list>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int NCW = 8;                 // consumer warps
constexpr int NT = 32 * (NCW + 1);     // + one producer warp
constexpr int RING_BYTES = 96 * 1024;  // the ring's target size
constexpr int MAX_STAGES = 8;
constexpr int MAX_SPLITS = 8;          // the portable cluster size
constexpr int SMEM_MAX = 200 * 1024;

struct Plan {
  int block_n, block_k, stages, splits, row_tile, blocks, stage_bytes;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// K4's launch geometry (mirrored by `w8_plan`); false when the kernel does
// not take the call
bool plan_for(int M, int K, int N, int is_f32, int sms, int block_n,
              int block_k, Plan* p) {
  if (M < 1 || M > 256 || K < 512 || N < 512 || K % 512 || N % 512 ||
      sms < 1)
    return false;
  const int mt = is_f32 ? (M == 1 ? 1 : 4) : (M <= 8 ? 8 : M <= 16 ? 16 : 128);
  // 128-column strips where they alone give half the SMs a block, else 64
  // (K split over a cluster), fp32 128 only; 256 K rows a stage, 128 with
  // 128-column bf16 strips
  const int wide = is_f32 || (mt <= 16 && ceil_div(M, mt) * (N / 128) * 2 >= sms);
  const int bn = block_n ? block_n : (wide ? 128 : 64);
  const int bk = block_k ? block_k : (wide && !is_f32 ? 128 : 256);
  if ((bn != 64 && bn != 128) || (is_f32 && bn != 128)) return false;
  if (bk != 64 && bk != 128 && bk != 256) return false;
  // the tensor-core warps take >= 16 K rows of a stage each
  const int wk = is_f32 ? 1 : (mt == 128 ? NCW / 4 : NCW);
  if (bk < 16 * wk) return false;
  const int base = ceil_div(M, mt) * (N / bn), tiles = K / bk;
  // bf16 x: the split one row block would take, also for a second 128-row
  // block (M 129-256), so a row's K order, and with it its bits, is the
  // same at every row count from 17 to 256 (a prefill wave's rows do not
  // depend on the rows it shares its call with)
  int splits = sms / (is_f32 ? base : N / bn);
  splits = splits < 1 ? 1 : (splits > MAX_SPLITS ? MAX_SPLITS : splits);
  while (tiles % splits) --splits;
  const int stage =
      ceil_div(bk * bn + mt * bk * (is_f32 ? 4 : 2), 1024) * 1024;
  int stages = RING_BYTES / stage;
  stages = stages < 2 ? 2 : (stages > MAX_STAGES ? MAX_STAGES : stages);
  // the ring also holds the warps' partials after the loop
  const int red = ceil_div((is_f32 ? NCW : wk) * mt * bn * 4, stage);
  stages = stages < red ? red : stages;
  *p = Plan{bn, bk, stages, splits, mt, base * splits, stage};
  return true;
}

struct Args {
  const float* ws;
  const void* b;
  void* out;
  int M, N, b_kind;        // b_kind: 0 none, 1 fp32, 2 bf16
  int block_k, stages, stage_bytes, tiles;  // tiles: K tiles of one split
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

// int8 -> fp32 (the fp32 route), exact: the byte, biased to unsigned, is
// the mantissa of 2^23 + u, and 2^23 + 128 comes off
__device__ __forceinline__ float widen(unsigned biased, int byte) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 | byte)) -
         8388736.f;
}

// bytes i of u and v as the bf16 pair (lo = u_i, hi = v_i), i = 0..3,
// exact: a byte b = l - 128 s (l its low seven bits, s its sign bit) is
// the bf16 sum of 128 + l (l as the mantissa under 2^7) and -(128 + 128 s)
// (s as the exponent's low bit under -2^7)
__device__ __forceinline__ void widen_pairs(unsigned u, unsigned v,
                                            unsigned (&o)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned p =
        __byte_perm(u, v, i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12));
    const unsigned mag = (p & 0x007F007Fu) | 0x43004300u;
    const unsigned neg = (p & 0x00800080u) | 0xC300C300u;
    const __nv_bfloat162 r =
        __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&mag),
                *reinterpret_cast<const __nv_bfloat162*>(&neg));
    o[i] = *reinterpret_cast<const unsigned*>(&r);
  }
}

// the four 32-bit words of BN / 8 = 16 (or the two of 8) weight bytes that
// thread group g reads from row r of a stage's swizzled weight box
template <int BN>
__device__ __forceinline__ void load_row(unsigned (&w)[BN / 32],
                                         const unsigned char* tile, int r,
                                         int g) {
  if constexpr (BN == 128) {
    // 128-byte swizzle: chunk c of row r at chunk c ^ (r % 8)
    const uint4 v = *reinterpret_cast<const uint4*>(
        tile + r * 128 + ((g ^ (r & 7)) << 4));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    // 64-byte swizzle: chunk c of row r at chunk c ^ ((r / 2) % 4)
    const uint2 v = *reinterpret_cast<const uint2*>(
        tile + r * 64 + (((g >> 1) ^ ((r >> 1) & 3)) << 4) + ((g & 1) << 3));
    w[0] = v.x; w[1] = v.y;
  }
}

// the fixed-order sums after the K loop: warps' partials red[wk] (natural
// column order, fp32) into red[0], then, in a cluster, every rank's red[0]
// in rank order for this block's share of the strip's columns; then ws and
// b (staged in `scale` during the loop), one rounding, the store. The sums
// of four outputs a thread are gathered before any is stored.
template <typename T, int MT, int BN, int WK>
__device__ __forceinline__ void finish(const Args& a, float* red,
                                       const float* scale, int n0, int m0) {
  constexpr int E = MT * BN;
  __syncthreads();                 // every warp's partials are written
  if constexpr (WK > 1) {
    for (int e = threadIdx.x; e < E; e += NT) {
      float v = red[e];
#pragma unroll
      for (int w = 1; w < WK; ++w) v += red[w * E + e];
      red[e] = v;
    }
  }
  const int splits = gridDim.x;
  cg::cluster_group cl = cg::this_cluster();
  // the block's sums (and, in a cluster, every rank's) are visible
  if (splits > 1)
    cl.sync();
  else if (WK > 1)
    __syncthreads();
  const int rank = splits > 1 ? (int)cl.block_rank() : 0;
  // rank r stores columns [r w, r w + w) of the strip, w = ceil(BN /
  // splits), the last share cut at BN (splits need not divide BN: 3, 5,
  // 6 and 7 split BN 64 / 128 unevenly)
  const int share = (BN + splits - 1) / splits, c0 = rank * share;
  const int width = c0 < BN ? min(share, BN - c0) : 0, total = MT * width;
  for (int e0 = threadIdx.x; e0 < total; e0 += 4 * NT) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * NT, i = e / width * BN + c0 + e % width;
      if (e >= total) continue;
      if (splits == 1) {
        v[u] = red[i];
      } else {
        // every rank's partial, from rank 0 up, whichever block sums
        v[u] = cl.map_shared_rank(red, 0)[i];
        for (int r = 1; r < splits; ++r) v[u] += cl.map_shared_rank(red, r)[i];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * NT, m = e / width, c = c0 + e % width;
      if (e < total && m0 + m < a.M)
        store_out(static_cast<T*>(a.out), (long long)(m0 + m) * a.N + n0 + c,
                  v[u] * scale[c] + scale[BN + c]);
    }
  }
  if (splits > 1) cl.sync();   // no block leaves while others read it
}

// the ring: `stages` stages of stage_bytes (a multiple of 1024, so every
// weight and x box starts on a swizzle atom), then 2 x stages mbarriers,
// then the strip's ws and b (2 x 128 floats)
struct Ring {
  unsigned char* base;
  unsigned long long* full;
  unsigned long long* empty;
  float* scale;
};

__device__ __forceinline__ Ring ring_of(unsigned char* smem, const Args& a) {
  unsigned char* base =
      smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(
      base + a.stages * a.stage_bytes);
  return Ring{base, bars, bars + a.stages,
              reinterpret_cast<float*>(bars + 2 * a.stages)};
}

// producer warp, lane 0: the K tiles of split blockIdx.x, in order; x
// boxes are xbox_k elements wide (64 bf16 = one 128-byte swizzle row, or a
// whole fp32 tile)
__device__ __forceinline__ void produce(const Ring& ring, const Args& a,
                                        const CUtensorMap* wmap,
                                        const CUtensorMap* xmap, int n0,
                                        int m0, int bn, int xbox_k,
                                        int xbox_bytes) {
  const int kt = a.block_k, t0 = blockIdx.x * a.tiles;
  const unsigned bytes = kt * bn + (kt / xbox_k) * xbox_bytes;
  for (int t = 0; t < a.tiles; ++t) {
    const int s = t % a.stages;
    if (t >= a.stages) mbar_wait(ring.empty + s, ((t / a.stages) - 1) & 1);
    unsigned char* st = ring.base + s * a.stage_bytes;
    mbar_expect(ring.full + s, bytes);
    const int k0 = (t0 + t) * kt;
    tma_load(st, wmap, n0, k0, ring.full + s);
    for (int i = 0; i < kt / xbox_k; ++i)
      tma_load(st + kt * bn + i * xbox_bytes, xmap, k0 + i * xbox_k, m0,
               ring.full + s);
  }
}

// the producer warp's other lanes stage the strip's ws and b while lane 0
// feeds the ring
__device__ __forceinline__ void stage_scale(const Ring& ring, const Args& a,
                                            int n0, int bn, int lane) {
  for (int c = lane - 1; c < bn; c += 31) {
    ring.scale[c] = a.ws[n0 + c];
    ring.scale[bn + c] = bias_at(a, n0 + c);
  }
}

// the producer lane sets up the ring's barriers and fetches the tensor
// maps while the previous kernel on the stream may still run (programmatic
// dependent launch); every thread then waits for that kernel's writes
// (griddepcontrol.wait) before anything reads global memory
__device__ __forceinline__ void ring_init(const Ring& ring, const Args& a,
                                          const CUtensorMap* wmap,
                                          const CUtensorMap* xmap) {
  if (threadIdx.x == NCW * 32) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, NCW * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(wmap) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(xmap) : "memory");
  }
  __syncthreads();
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// the next kernel on the stream may start its own set-up
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// a consumer warp of `w8_mma` (below): its share of every stage's
// products into acc
template <int BN, int MF, int WK>
__device__ __forceinline__ void mma_loop(const Ring& ring, const Args& a,
                                         int warp, int lane,
                                         float (&acc)[BN / 16][MF][4]) {
  constexpr int MT = NCW / WK * 8 * MF, NJ = BN / 16;
  constexpr int XBOX = MT * 128;
  const int g = lane >> 2, t4 = lane & 3;
  const int wk = warp % WK, wm = warp / WK;
  const int kt = a.block_k, kpw = kt / WK;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][f][e] = 0.f;

  // ldmatrix rows of this lane: matrix q = lane / 8 of x4 call h is (n8
  // tile 2 h + q / 2, k half q % 2); for MF 1 one x2 call, (k half q % 2)
  const int q = lane >> 3;
  const int xm = wm * 8 * MF + (MF > 1 ? 8 * (q >> 1) : 0) + (lane & 7);
  const int xh = q & 1;

  for (int t = 0; t < a.tiles; ++t) {
    const int s = t % a.stages;
    mbar_wait(ring.full + s, (t / a.stages) & 1);
    const unsigned char* wt = ring.base + s * a.stage_bytes;
    const unsigned char* xt = wt + kt * BN;
#pragma unroll 2
    for (int kk = wk * kpw; kk < (wk + 1) * kpw; kk += 16) {
      unsigned r0[BN / 32], r1[BN / 32], r2[BN / 32], r3[BN / 32];
      load_row<BN>(r0, wt, kk + 2 * t4, g);
      load_row<BN>(r1, wt, kk + 2 * t4 + 1, g);
      load_row<BN>(r2, wt, kk + 2 * t4 + 8, g);
      load_row<BN>(r3, wt, kk + 2 * t4 + 9, g);
      // x^T fragments: box kk / 64, 16-byte chunk (kk % 64) / 8 + half
      const unsigned char* xb = xt + (kk >> 6) * XBOX;
      const int c = ((kk & 63) >> 3) + xh;
      const unsigned char* xp = xb + xm * 128 + ((c ^ (xm & 7)) << 4);
      unsigned bx[MF][2];
      if constexpr (MF == 1) {
        ldsm_x2(bx[0], xp);
      } else {
#pragma unroll
        for (int h = 0; h < MF / 2; ++h) ldsm_x4(bx[2 * h], xp + h * 16 * 128);
      }
#pragma unroll
      for (int w = 0; w < BN / 32; ++w) {
        unsigned lo[4], hi[4];
        widen_pairs(r0[w], r1[w], lo);   // K rows 2 t4, 2 t4 + 1
        widen_pairs(r2[w], r3[w], hi);   // K rows 2 t4 + 8, 2 t4 + 9
        // bytes 4w, 4w + 1 are n-tile 2w's rows g and g + 8, bytes
        // 4w + 2, 4w + 3 n-tile 2w + 1's
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const unsigned af[4] = {lo[2 * jj], lo[2 * jj + 1], hi[2 * jj],
                                  hi[2 * jj + 1]};
#pragma unroll
          for (int f = 0; f < MF; ++f)
            mma_bf16_k16(acc[2 * w + jj][f], af, bx[f][0], bx[f][1]);
        }
      }
    }
    mbar_arrive(ring.empty + s);
  }
}

// a consumer warp's acc into the partials red[warp % WK] (natural column
// order; D rows g, g + 8 of n-tile j are columns g BN / 8 + 2 j (+ 1), D
// columns 2 t4, 2 t4 + 1 are x rows)
template <int BN, int MF, int WK>
__device__ __forceinline__ void mma_partials(float* red, int warp, int lane,
                                             const float (&acc)[BN / 16][MF][4]) {
  constexpr int MT = NCW / WK * 8 * MF, NJ = BN / 16;
  const int g = lane >> 2, t4 = lane & 3;
  const int wk = warp % WK, wm = warp / WK;
  red += wk * MT * BN;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int f = 0; f < MF; ++f) {
      const int col = g * (BN / 8) + 2 * j;
      const int m = wm * 8 * MF + 8 * f + 2 * t4;
      *reinterpret_cast<float2*>(red + m * BN + col) =
          make_float2(acc[j][f][0], acc[j][f][2]);
      *reinterpret_cast<float2*>(red + (m + 1) * BN + col) =
          make_float2(acc[j][f][1], acc[j][f][3]);
    }
}

// a consumer warp of `w8_fma` (below), as mma_loop
template <int MR>
__device__ __forceinline__ void fma_loop(const Ring& ring, const Args& a,
                                         int warp, int lane,
                                         float (&acc)[MR][4]) {
  constexpr int BN = 128;
  const int kt = a.block_k, kpw = kt / NCW;
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int t = 0; t < a.tiles; ++t) {
    const int s = t % a.stages;
    mbar_wait(ring.full + s, (t / a.stages) & 1);
    const unsigned char* wt = ring.base + s * a.stage_bytes;
    const float* xt = reinterpret_cast<const float*>(wt + kt * BN);
#pragma unroll 2
    for (int kk = warp * kpw; kk < (warp + 1) * kpw; kk += 4) {
      unsigned w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = kk + i;
        w[i] = *reinterpret_cast<const unsigned*>(
                   wt + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) +
                   ((lane & 3) << 2)) ^ 0x80808080u;
      }
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xt + r * kt + kk);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[r][j] = fmaf(xs[i], widen(w[i], j), acc[r][j]);
      }
    }
    mbar_arrive(ring.empty + s);
  }
}

template <int MR>
__device__ __forceinline__ void fma_partials(float* red, int warp, int lane,
                                             const float (&acc)[MR][4]) {
  constexpr int BN = 128;
  red += warp * MR * BN;
#pragma unroll
  for (int r = 0; r < MR; ++r)
    *reinterpret_cast<float4*>(red + r * BN + 4 * lane) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// bf16 x on the tensor cores. MF: n8 tiles of x rows a warp (rows 8 MF);
// WK: warps along K (NCW: the warps split each stage's K rows over one x
// tile of 8 MF rows; NCW / 4: four slices of 32 rows of a 128-row x tile,
// each over 1 / WK of the stage's K rows)
template <int BN, int MF, int WK>
__global__ void __launch_bounds__(NT)
    w8_mma(const __grid_constant__ CUtensorMap wmap,
           const __grid_constant__ CUtensorMap xmap, Args a) {
  constexpr int MT = NCW / WK * 8 * MF;
  constexpr int XBOX = MT * 128;     // one x box: MT rows of 64 bf16
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring ring = ring_of(smem, a);
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ring_init(ring, a, &wmap, &xmap);

  float* red = reinterpret_cast<float*>(ring.base);
  float acc[BN / 16][MF][4];
  if (warp == NCW) {
    if (lane == 0)
      produce(ring, a, &wmap, &xmap, n0, m0, BN, 64, XBOX);
    else
      stage_scale(ring, a, n0, BN, lane);
  } else {
    mma_loop<BN, MF, WK>(ring, a, warp, lane, acc);
  }
  let_next_start();
  __syncthreads();     // every warp is past the loop: the ring is free
  if (warp < NCW) mma_partials<BN, MF, WK>(red, warp, lane, acc);
  finish<bf16, MT, BN, WK>(a, red, ring.scale, n0, m0);
}

// fp32 x on the CUDA cores: MR rows of x a block, each lane four adjacent
// columns of the 128-column strip, the four warps a quarter of each
// stage's K rows
template <int MR>
__global__ void __launch_bounds__(NT)
    w8_fma(const __grid_constant__ CUtensorMap wmap,
           const __grid_constant__ CUtensorMap xmap, Args a) {
  constexpr int BN = 128;
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring ring = ring_of(smem, a);
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * MR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kt = a.block_k;
  ring_init(ring, a, &wmap, &xmap);

  float* red = reinterpret_cast<float*>(ring.base);
  float acc[MR][4];
  if (warp == NCW) {
    if (lane == 0)
      produce(ring, a, &wmap, &xmap, n0, m0, BN, kt, MR * kt * 4);
    else
      stage_scale(ring, a, n0, BN, lane);
  } else {
    fma_loop<MR>(ring, a, warp, lane, acc);
  }
  let_next_start();
  __syncthreads();     // every warp is past the loop: the ring is free
  if (warp < NCW) fma_partials<MR>(red, warp, lane, acc);
  finish<float, MR, BN, NCW>(a, red, ring.scale, n0, m0);
}

typedef void (*Kernel)(const CUtensorMap, const CUtensorMap, Args);

Kernel kernel_for(int is_f32, int bn, int mt) {
  constexpr int W = NCW, W4 = NCW / 4;
  if (is_f32) return mt == 1 ? w8_fma<1> : w8_fma<4>;
  if (bn == 128)
    return mt == 8 ? w8_mma<128, 1, W> : mt == 16 ? w8_mma<128, 2, W>
                                                  : w8_mma<128, 4, W4>;
  return mt == 8 ? w8_mma<64, 1, W> : mt == 16 ? w8_mma<64, 2, W>
                                               : w8_mma<64, 4, W4>;
}

// lets every kernel above take up to SMEM_MAX bytes of dynamic shared
// memory (set once a process)
cudaError_t allow_smem() {
  static const cudaError_t e = [] {
    for (int f32 = 0; f32 < 2; ++f32)
      for (int bn : {64, 128})
        for (int mt : {1, 4, 8, 16, 128}) {
          if ((f32 && (bn != 128 || mt > 4)) || (!f32 && mt < 8)) continue;
          const cudaError_t r = cudaFuncSetAttribute(
              kernel_for(f32, bn, mt),
              cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
          if (r != cudaSuccess) return r;
        }
    return cudaSuccess;
  }();
  return e;
}

int smem_bytes(const Plan& p) {
  return 1024 + p.stages * p.stage_bytes + 2 * p.stages * 8 + 2 * 128 * 4;
}

}  // namespace

// The plan gill_w8_matmul takes for (M, K, N) on a card with `sms` SMs
// and the requested block_n / block_k (0: the default): out[0..5] =
// block_n, block_k, stages, splits, row_tile, blocks. Returns 0, or
// cudaErrorInvalidValue when the kernel does not take the call.
extern "C" int gill_w8_plan(int M, int K, int N, int is_f32, int sms,
                            int block_n, int block_k, int* out) {
  Plan p;
  if (!plan_for(M, K, N, is_f32, sms, block_n, block_k, &p))
    return (int)cudaErrorInvalidValue;
  const int v[6] = {p.block_n, p.block_k, p.stages, p.splits, p.row_tile,
                    p.blocks};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// x (M, K) contiguous, bf16 (is_f32 = 0) or fp32 (is_f32 = 1), 16-byte
// aligned; w (K rows of N int8, row stride ldw, a multiple of 16, 16-byte
// aligned); ws (N,) fp32; b (N,) per b_kind (0 none, 1 fp32, 2 bf16); out
// (M, N) contiguous in x's dtype. block_n, block_k, stages, splits and
// row_tile must be the plan gill_w8_plan gives for (M, K, N, is_f32, sms,
// block_n, block_k). One launch. Returns a cudaError_t (0 = launched; an
// invalid value also for any other plan or when a tensor map cannot be
// made).
extern "C" int gill_w8_matmul(int is_f32, const void* x, const void* w,
                              long long ldw, const void* ws, const void* b,
                              int b_kind, void* out, int M, int K, int N,
                              int sms, int block_n, int block_k, int stages,
                              int splits, int row_tile, void* stream) {
  Plan p;
  if (!plan_for(M, K, N, is_f32, sms, block_n, block_k, &p) ||
      p.block_n != block_n || p.block_k != block_k || p.stages != stages ||
      p.splits != splits || p.row_tile != row_tile || ldw < N || ldw % 16 ||
      b_kind < 0 || b_kind > 2 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap wmap, xmap;
  const int bn = p.block_n, bk = p.block_k, mt = p.row_tile;
  if (!tensor_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, ldw, bk,
                     bn, bn == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  const bool xok =
      is_f32 ? tensor_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, M, K,
                             4ull * K, mt, bk, CU_TENSOR_MAP_SWIZZLE_NONE)
             : tensor_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K,
                             2ull * K, mt, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!xok) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  if (smem_bytes(p) > SMEM_MAX) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(ws), b, out, M, N, b_kind,
         bk, p.stages, p.stage_bytes, K / bk / p.splits};
  // grid (splits, strips, row blocks); attr[0] the cluster of the K
  // splits (where K is split), attr[1] programmatic dependent launch
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, N / bn, ceil_div(M, mt));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes(p);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = p.splits > 1 ? attr : attr + 1;
  cfg.numAttrs = p.splits > 1 ? 2 : 1;
  e = cudaLaunchKernelEx(&cfg, kernel_for(is_f32, bn, mt), wmap, xmap, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
