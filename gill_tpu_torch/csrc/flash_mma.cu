// Flash attention forward on mma.sync for Hopper (sm_90a): every bf16
// flash-attention call of the port, one kernel template with two QK
// stages: the SD UNet's attention at head dims <= 80 (K2), its int8-QK
// twin (K10), and K1's bf16 calls at head dims 128-512 (the UNet's 160,
// the VAE's 512, the W8 serving engines' OPT prefill at 128).
//
// Replaces
//  * K2: gill_tpu/ops/attention.py `flash_attention_bthd` (Pallas body
//    `_flash_kernel`), and K1 in bf16: `flash_attention` (the same body):
//    out = softmax(scale q k^T) v, bf16 in and out, fp32 statistics, the
//    probabilities rounded to bf16 for the P.V product, causal masking
//    aligned bottom-right (key j visible to query i when j <= i + S - T),
//    keys at or past `kv_len` masked;
//  * K10: `flash_attention_bthd(q8=True)` (Pallas body `_flash_kernel_i8`):
//    k int8 per (b, h), q int8 per (b, h, group of `qblock` rows), scores
//    float(int32 q.k) * ((sq * sk) * scale), then the same softmax and P.V.
//    Non-causal. The pre-pass below writes the int8 operands.
// q (B, T, H, D) and k/v (B, S, H, D) come with their own strides (16-byte
// aligned rows, the wrapper copies otherwise); D is a multiple of 8 (the
// wrapper zero-pads it otherwise), at most 512 (bf16) or 128 (K10, whose
// UNet gate is d < 128), zero-filled up to the kernel's head dim (bf16 40,
// 80, 128, 160, 256, 512); out is a contiguous (B, T, H, D).
//
// What bounds it on an H100 (132 SMs, 989 TFLOP/s bf16, ~3.9e12
// exponentials/s on the special-function units):
//  * 64 x 64 self-attention (T = S = 4096, D = 40, B*H = 16): 268M
//    exponentials take >= 0.069 ms, the products 0.043 ms at the full
//    tensor rate: the exponentials bind, and int8 QK (K10) can only shrink
//    the term that does not;
//  * 32 x 32 self-attention (T = S = 1024, D = 80) and the VAE's one head
//    (T = S = 4096, D = 512: 0.035 ms): the products bind; the VAE's
//    4096 rows of a single (b, h) are few blocks for 132 SMs;
//  * the 77-key cross-attention and the head-dim-160 calls of the UNet's
//    16 x 16 and 8 x 8 levels (0.0004-0.0016 ms): the bytes of q and out
//    bind, and the calls are a few microseconds of launch and tail.
// The design (the FlashAttention-2 shape), against each:
//  * one block = BQ query rows of one (b, h), one warp per 16 rows; Q is
//    loaded once into registers as mma.sync A fragments (ldmatrix);
//  * S = Q K^T on mma.sync m16n8k16 (bf16, fp32 sums) or m16n8k32 (int8,
//    int32 sums) into registers, 16 x BK a warp, never stored; a head dim
//    that is an odd number of 16-byte chunks (D 40 bf16, every int8 row)
//    ends in one k8 (bf16) or k16 (int8) step, so D 40 is not padded to 48;
//  * the online softmax runs on those registers: a row's max and sum over
//    the quad of lanes that own it (shuffles 1 and 2), scale * log2(e)
//    folded into one FMA before exp2 (ex2.approx), the O accumulators
//    rescaled in registers, the row sums kept per lane and reduced once at
//    the end; masked keys take -inf (a row with no visible key yields 0);
//  * P goes to bf16 in registers and is the A operand of P.V as it stands
//    (two neighbouring m16n8 C tiles are one m16n8k16 A tile); V is the B
//    operand through ldmatrix.trans of its [key][d] tile; O, 16 x D fp32 a
//    warp, stays in registers from the first key tile to the epilogue;
//  * at head dims 256 and 512 a strip's 16 x D fp32 output would take 128
//    or 256 registers a lane, so WS = 2 or 4 warps share each 16-row
//    strip, each owning 128 columns of the QK depth and of O; their
//    partial 16 x BK scores meet in shared memory behind a named barrier
//    of the strip, and every warp sums them in the same order, so all run
//    the same softmax; the VAE takes 32 x 32 tiles (eight warps: one block
//    an SM by shared memory, 128 blocks in one wave);
//  * K/V tiles stream through a two-stage ring in shared memory filled by
//    16-byte cp.async.cg with one block barrier per key tile: tile j + 1 is
//    in flight while tile j is computed. The ragged key edge and the head
//    dim past D are zero-filled by the copies' source size, and rows are
//    an odd number of 16-byte chunks apart, so ldmatrix is conflict-free;
//  * the epilogue divides by max(l, 1e-30), stages the warp's bf16 rows
//    (and columns) in its own slab of shared memory and writes them with
//    16-byte stores;
//  * BQ and BK are template parameters, chosen by the wrapper
//    (`ops/attention.py` `flash_plan`): K2 in {64, 128}^2 (`mma_tile`, by
//    shape or by the caller), head dims 128 / 160 64 x 64, 256 / 512
//    32 x 32.
// K10's pre-pass is two launches spread over the card, one block per
// (b, h, 64 rows of a segment), a segment being one q group or the keys,
// 16-byte loads four in flight a thread: `qk_amax` writes each block's
// amax (level one); `qk_quantize` reduces its segment's block maxima
// (level two), writes the scale max(amax / 127, 1e-12) and its rows as
// int8 (round half to even of x / scale, clip to +-127: bit-equal to the
// plain `_int8_sym` on the CPU), zero-padded to a 16-byte multiple, into
// (B*H, T|S, row bytes) scratch; the quotient takes one reciprocal a block
// and two FMAs a value (`quant8`), checked exhaustively against a true
// division. One launch with a cluster of 8 blocks a segment, the maxima
// meeting in distributed shared memory, was slower on the H100: the
// cluster barrier, and the registers that held a slice across it, cost
// more than the second launch.
// TMA and wgmma are later work.

#include <algorithm>
#include <cmath>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// PTX wrappers of the int8 stage (the bf16 ones are in common.cuh)
// ---------------------------------------------------------------------------

// m16n8k32 int8 (32 bytes of depth), int32 sums
__device__ __forceinline__ void mma_s8_k32(int* c, const unsigned* a,
                                           unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// m16n8k16 int8 (16 bytes of depth)
__device__ __forceinline__ void mma_s8_k16(int* c, const unsigned* a,
                                           unsigned b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// ---------------------------------------------------------------------------
// the attention kernel
// ---------------------------------------------------------------------------

struct Params {
  const unsigned char* q;   // bf16 q, or the int8 q scratch
  const unsigned char* k;   // bf16 k, or the int8 k scratch
  const unsigned char* v;   // bf16
  unsigned char* o;         // bf16 (B, T, H, D)
  const float* sq;          // int8 stage: (B*H, ngroups) q scales
  const float* sk;          // int8 stage: (B*H) k scales
  int B, T, S, H, D, kv_len, causal, qblock, ngroups;
  int ncq;                  // 16-byte chunks of a q/k row holding data
  // strides in bytes
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

constexpr int odd_up(int n) { return n | 1; }

// WS warps share each 16-row strip of the block, warp w % WS owning the
// head-dim columns [w % WS * DK / WS, + DK / WS) of the QK depth and of O
// (WS 1 at head dims <= 160; 2 and 4 at 256 and 512, where a strip's
// (16, DK) fp32 output would not fit one warp's registers)
template <bool I8, int DK, int BQ, int BK, int WS = 1> struct Cfg {
  static constexpr int NW = BQ / 16 * WS, NTH = NW * 32;
  // q/k rows: 16-byte chunks (bf16: D 40 -> 5, 80 -> 10; int8: 40 -> 3,
  // 80 -> 5), consumed 32 bytes a step plus a 16-byte tail step
  static constexpr int NCQ = I8 ? (DK + 15) / 16 : DK / 8;
  static constexpr int NCW = NCQ / WS;                // a warp's QK chunks
  static constexpr int NFULL = NCW / 2;
  static constexpr bool TAIL = NCW % 2 == 1;
  static constexpr int NDT = DK / 8 / WS;             // a warp's n8 tiles of O
  // shared row strides in chunks: odd, so the 8 rows an ldmatrix reads
  // fall in 8 different 16-byte bank groups
  static constexpr int LK = odd_up(NCQ), LV = odd_up(DK / 8);
  static constexpr int LX = LK > LV ? LK : LV;        // Q tile / out staging
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = BQ * LX * 16;
  static constexpr int K_BYTES = BK * LK * 16, V_BYTES = BK * LV * 16;
  // WS > 1: each warp's partial (16, BK) scores, as C fragments (the
  // block barrier that opens every key tile orders their reuse)
  static constexpr int PS_BYTES = WS > 1 ? NW * (BK / 8) * 32 * 16 : 0;
  static constexpr int SMEM = Q_BYTES + STAGES * (K_BYTES + V_BYTES) +
                              PS_BYTES;
  static_assert(DK % 8 == 0 && BK % 16 == 0 && BQ % 16 == 0, "tile");
  static_assert(WS == 1 || (!I8 && NCQ % WS == 0 && DK / 8 % WS == 0),
                "a column split takes bf16 and whole chunks a warp");
};

// rows [0, n) of a global matrix (row stride rs bytes, 16-byte aligned)
// into a [ROWS][LD] shared tile of 16-byte chunks; chunks at or past nc and
// rows at or past n are zero-filled by the copy's source size
template <int ROWS, int NC, int LD, int NTH>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const unsigned char* src,
                                          long long rs, int n, int nc,
                                          int tid) {
#pragma unroll
  for (int i = tid; i < ROWS * NC; i += NTH) {
    const int r = i / NC, c = i - (i / NC) * NC;
    const bool ok = r < n && c < nc;
    cp_async16_zf(dst + (r * LD + c) * 16, ok ? src + r * rs + c * 16 : src,
                  ok);
  }
}

template <bool I8, int DK, int BQ, int BK, int WS>
__global__ void __launch_bounds__(Cfg<I8, DK, BQ, BK, WS>::NTH)
    flash_mma(const Params p) {
  using C = Cfg<I8, DK, BQ, BK, WS>;
  constexpr int NTH = C::NTH, NCQ = C::NCQ, NCW = C::NCW, NFULL = C::NFULL;
  constexpr int NDT = C::NDT, NDK = DK / 8;
  constexpr int LK = C::LK, LV = C::LV, LX = C::LX, NT = BK / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;
  unsigned char* ks = qs + C::Q_BYTES;
  unsigned char* vs = ks + C::STAGES * C::K_BYTES;
  float4* ps = reinterpret_cast<float4*>(vs + C::STAGES * C::V_BYTES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;        // mma fragment row / pair
  const int mi = lane >> 3, mr = lane & 7;       // ldmatrix matrix / row
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;
  const unsigned char* qg = p.q + b * p.q_sb + h * p.q_sh;
  const unsigned char* kg = p.k + b * p.k_sb + h * p.k_sh;
  const unsigned char* vg = p.v + b * p.v_sb + h * p.v_sh;
  const int ncv = p.D / 8;

  const int off = p.S - p.T;
  int kend = min(p.kv_len, p.S);
  if (p.causal) kend = min(kend, min(q0 + BQ, p.T) + off);
  const int nkt = kend > 0 ? (kend + BK - 1) / BK : 0;

  load_tile<BQ, NCQ, LX, NTH>(qs, qg + q0 * p.q_st, p.q_st,
                              min(BQ, p.T - q0), p.ncq, tid);
  if (nkt > 0) {
    const int nk = min(BK, p.S);
    load_tile<BK, NCQ, LK, NTH>(ks, kg, p.k_ss, nk, p.ncq, tid);
    load_tile<BK, NDK, LV, NTH>(vs, vg, p.v_ss, nk, ncv, tid);
  }
  cp_async_commit();
  cp_async_wait_prior<0>();
  __syncthreads();

  // this warp's 16 rows (strip warp / WS) of Q as A fragments, its own
  // chunks [cq, cq + NCW) of the depth, for the whole key loop
  const int strip = warp / WS, wc = warp % WS;
  const int r0 = strip * 16, cq = wc * NCW, co = wc * NDT;
  unsigned qa[NFULL > 0 ? NFULL : 1][4], qt[2];
#pragma unroll
  for (int st = 0; st < NFULL; ++st)
    ldsm_x4(qa[st], qs + ((r0 + (mi & 1) * 8 + mr) * LX + cq + 2 * st +
                          (mi >> 1)) * 16);
  if constexpr (C::TAIL)
    ldsm_x2(qt, qs + ((r0 + (mi & 1) * 8 + mr) * LX + cq + NCW - 1) * 16);

  // scale * log2(e) of this lane's two rows (g and g + 8)
  float c_lo, c_hi;
  if constexpr (I8) {
    const int rl = min(q0 + r0 + g, p.T - 1), rh = min(q0 + r0 + g + 8,
                                                      p.T - 1);
    const float skv = p.sk[bh];
    const float* sqr = p.sq + (long long)bh * p.ngroups;
    c_lo = __fmul_rn(__fmul_rn(__fmul_rn(sqr[rl / p.qblock], skv), p.scale),
                     LOG2E);
    c_hi = __fmul_rn(__fmul_rn(__fmul_rn(sqr[rh / p.qblock], skv), p.scale),
                     LOG2E);
  } else {
    c_lo = c_hi = p.scale * LOG2E;
  }

  float o[NDT][4];
#pragma unroll
  for (int i = 0; i < NDT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  for (int j = 0; j < nkt; ++j) {
    if (j > 0) {
      cp_async_wait_prior<0>();   // tile j has landed
      __syncthreads();            // for every warp; and tile j - 1 is read
    }
    if (j + 1 < nkt) {
      const int k1 = (j + 1) * BK, nk = min(BK, p.S - k1);
      const int st = (j + 1) & 1;
      load_tile<BK, NCQ, LK, NTH>(ks + st * C::K_BYTES, kg + k1 * p.k_ss,
                                  p.k_ss, nk, p.ncq, tid);
      load_tile<BK, NDK, LV, NTH>(vs + st * C::V_BYTES, vg + k1 * p.v_ss,
                                  p.v_ss, nk, ncv, tid);
    }
    cp_async_commit();
    const unsigned char* kst = ks + (j & 1) * C::K_BYTES;
    const unsigned char* vst = vs + (j & 1) * C::V_BYTES;
    const int k0 = j * BK;

    // S = Q K^T: (16, BK) a warp, in registers
    float s[NT][4];
    if constexpr (I8) {
      int si[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) si[n][0] = si[n][1] = si[n][2] = si[n][3] = 0;
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
#pragma unroll
        for (int st = 0; st < NFULL; ++st) {
          unsigned bm[4];
          ldsm_x4(bm, kst + ((kt * 16 + (mi >> 1) * 8 + mr) * LK + cq +
                             2 * st + (mi & 1)) * 16);
          mma_s8_k32(si[2 * kt], qa[st], bm[0], bm[1]);
          mma_s8_k32(si[2 * kt + 1], qa[st], bm[2], bm[3]);
        }
        if constexpr (C::TAIL) {
          unsigned bm[2];
          ldsm_x2(bm, kst + ((kt * 16 + (mi & 1) * 8 + mr) * LK + cq + NCW -
                             1) * 16);
          mma_s8_k16(si[2 * kt], qt, bm[0]);
          mma_s8_k16(si[2 * kt + 1], qt, bm[1]);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = __int2float_rn(si[n][e]);
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
#pragma unroll
        for (int st = 0; st < NFULL; ++st) {
          unsigned bm[4];
          ldsm_x4(bm, kst + ((kt * 16 + (mi >> 1) * 8 + mr) * LK + cq +
                             2 * st + (mi & 1)) * 16);
          mma_bf16_k16(s[2 * kt], qa[st], bm[0], bm[1]);
          mma_bf16_k16(s[2 * kt + 1], qa[st], bm[2], bm[3]);
        }
        if constexpr (C::TAIL) {
          unsigned bm[2];
          ldsm_x2(bm, kst + ((kt * 16 + (mi & 1) * 8 + mr) * LK + cq + NCW -
                             1) * 16);
          mma_bf16_k8(s[2 * kt], qt, bm[0]);
          mma_bf16_k8(s[2 * kt + 1], qt, bm[1]);
        }
      }
      if constexpr (WS > 1) {
        // the strip's WS partial scores meet in shared memory; every warp
        // of the strip sums them in the same order, so all hold the same S
#pragma unroll
        for (int n = 0; n < NT; ++n)
          ps[(warp * NT + n) * 32 + lane] =
              make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + strip), "n"(WS * 32)
                     : "memory");
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float4 t = ps[((strip * WS) * NT + n) * 32 + lane];
#pragma unroll
          for (int w = 1; w < WS; ++w) {
            const float4 u = ps[((strip * WS + w) * NT + n) * 32 + lane];
            t.x += u.x;
            t.y += u.y;
            t.z += u.z;
            t.w += u.w;
          }
          s[n][0] = t.x;
          s[n][1] = t.y;
          s[n][2] = t.z;
          s[n][3] = t.w;
        }
      }
    }

    // masks: only the tile over the key edge and, causal, over the diagonal
    if (k0 + BK > p.kv_len ||
        (p.causal && k0 + BK - 1 > q0 + r0 + off)) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * n + 2 * t4 + (e & 1);
          const int qr = q0 + r0 + g + 8 * (e >> 1);
          if (kp >= p.kv_len || (p.causal && kp > qr + off))
            s[n][e] = -INFINITY;
        }
    }

    // online softmax of the two rows, across the quad that owns each
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, sh));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, sh));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo * c_lo);
    const float mn_hi = fmaxf(m_hi, mx_hi * c_hi);
    // a row with no visible key yet: shift by 0, so exp2(-inf) = 0
    const float u_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float u_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float a_lo = ex2(m_lo - u_lo), a_hi = ex2(m_hi - u_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
    unsigned pp[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float p0 = ex2(fmaf(s[n][0], c_lo, -u_lo));
      const float p1 = ex2(fmaf(s[n][1], c_lo, -u_lo));
      const float p2 = ex2(fmaf(s[n][2], c_hi, -u_hi));
      const float p3 = ex2(fmaf(s[n][3], c_hi, -u_hi));
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      pp[n][0] = pack_bf16(p0, p1);
      pp[n][1] = pack_bf16(p2, p3);
    }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
    for (int i = 0; i < NDT; ++i) {
      o[i][0] *= a_lo;
      o[i][1] *= a_lo;
      o[i][2] *= a_hi;
      o[i][3] *= a_hi;
    }

    // O += P V: P's C tiles 2kk and 2kk + 1 are the A tile of keys
    // [16kk, 16kk + 16); V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned a[4] = {pp[2 * kk][0], pp[2 * kk][1], pp[2 * kk + 1][0],
                             pp[2 * kk + 1][1]};
#pragma unroll
      for (int dp = 0; dp < NDT / 2; ++dp) {
        unsigned bm[4];
        ldsm_x4_t(bm, vst + ((kk * 16 + (mi & 1) * 8 + mr) * LV + co +
                             2 * dp + (mi >> 1)) * 16);
        mma_bf16_k16(o[2 * dp], a, bm[0], bm[1]);
        mma_bf16_k16(o[2 * dp + 1], a, bm[2], bm[3]);
      }
      if constexpr (NDT % 2 == 1) {
        unsigned bm[2];
        ldsm_x2_t(bm, vst + ((kk * 16 + (mi & 1) * 8 + mr) * LV + co + NDT -
                             1) * 16);
        mma_bf16_k16(o[NDT - 1], a, bm[0], bm[1]);
      }
    }
  }

  // epilogue: the quad's row sums, O / max(l, 1e-30) to bf16 through this
  // warp's own rows and columns of the Q tile (every warp has read its Q
  // fragments, and the warps of a strip own disjoint columns), then
  // 16-byte stores
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, sh);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, sh);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  unsigned char* slab = qs + r0 * LX * 16;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < NDT; ++i) {
    *reinterpret_cast<unsigned*>(slab + (g * LX + co + i) * 16 + t4 * 4) =
        pack_bf16(o[i][0] * inv_lo, o[i][1] * inv_lo);
    *reinterpret_cast<unsigned*>(slab + ((g + 8) * LX + co + i) * 16 +
                                 t4 * 4) =
        pack_bf16(o[i][2] * inv_hi, o[i][3] * inv_hi);
  }
  __syncwarp();
  const long long orow = (long long)p.H * p.D * 2;
  unsigned char* og = p.o + ((long long)b * p.T * p.H + h) * p.D * 2;
  for (int i = lane; i < 16 * NDT; i += 32) {
    const int r = i / NDT, c = co + i - (i / NDT) * NDT, qr = q0 + r0 + r;
    if (qr < p.T && c < ncv)
      *reinterpret_cast<uint4*>(og + qr * orow + c * 16) =
          *reinterpret_cast<const uint4*>(slab + (r * LX + c) * 16);
  }
}

template <bool I8, int DK, int BQ, int BK, int WS = 1>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<I8, DK, BQ, BK, WS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_mma<I8, DK, BQ, BK, WS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.T + BQ - 1) / BQ, p.B * p.H);
  flash_mma<I8, DK, BQ, BK, WS><<<grid, C::NTH, C::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// head dims 40 and 80 (K2, K10) and int8 128 (K10): (BQ, BK) in {64, 128}^2
template <bool I8, int DK>
cudaError_t by_tile(const Params& p, int bq, int bk, cudaStream_t st) {
  if (bq == 64 && bk == 64) return launch<I8, DK, 64, 64>(p, st);
  if (bq == 64 && bk == 128) return launch<I8, DK, 64, 128>(p, st);
  if (bq == 128 && bk == 64) return launch<I8, DK, 128, 64>(p, st);
  if (bq == 128 && bk == 128) return launch<I8, DK, 128, 128>(p, st);
  return cudaErrorInvalidValue;
}


// the kernel's head dim for D (a multiple of 8): bf16 40, 80, 128, 160,
// 256 or 512; int8 QK 40, 80 or 128; 0 for others
int kernel_dim(int D, bool i8) {
  if (D <= 0 || D % 8) return 0;
  if (i8) return D <= 40 ? 40 : D <= 80 ? 80 : D <= 128 ? 128 : 0;
  for (int dk : {40, 80, 128, 160, 256, 512})
    if (D <= dk) return dk;
  return 0;
}

template <bool I8>
cudaError_t dispatch(const Params& p, int bq, int bk, cudaStream_t st) {
  if (p.B <= 0 || p.T <= 0 || p.S <= 0 || p.H <= 0 || p.B * p.H > 65535 ||
      p.kv_len <= 0 || p.kv_len > p.S)
    return cudaErrorInvalidValue;
  const int dk = kernel_dim(p.D, I8);
  if (dk == 40) return by_tile<I8, 40>(p, bq, bk, st);
  if (dk == 80) return by_tile<I8, 80>(p, bq, bk, st);
  if constexpr (I8) {
    if (dk == 128) return by_tile<I8, 128>(p, bq, bk, st);
  } else {
    // K1: 64 x 64 tiles at 128 and 160; 32 x 32 at 256 and 512, two and
    // four warps a 16-row strip
    const int tile = dk <= 160 ? 64 : 32;
    if (bq != tile || bk != tile) return cudaErrorInvalidValue;
    if (dk == 128) return launch<false, 128, 64, 64>(p, st);
    if (dk == 160) return launch<false, 160, 64, 64>(p, st);
    if (dk == 256) return launch<false, 256, 32, 32, 2>(p, st);
    if (dk == 512) return launch<false, 512, 32, 32, 4>(p, st);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr, std::initializer_list<long long> strides) {
  bool ok = reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (long long s : strides) ok = ok && s % 8 == 0;
  return ok;
}

// ---------------------------------------------------------------------------
// K10's pre-pass: two launches over (b, h, segment, 64-row part) blocks
// ---------------------------------------------------------------------------

constexpr int PT = 128;        // threads
constexpr int PR = 64;         // rows a block takes
constexpr int U = 4;           // 16-byte loads a thread keeps in flight

struct QParams {
  const bf16* q;
  const bf16* k;
  signed char* qq;             // (B*H, T, RB)
  signed char* kq;             // (B*H, S, RB)
  float* sq;                   // (B*H, ngroups)
  float* sk;                   // (B*H)
  float* part;                 // (B*H, ngroups * pq + pk) block maxima
  int B, T, S, H, D, RB, qblock, ngroups, pq, pk, vec;
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh;   // elements
};

// the rows [row0, row0 + n) of one block: part j of (b, h) is part j % pq
// of q group j / pq while j < ngroups * pq, then part j - ngroups * pq of
// the keys; its segment's parts are part[p0, p0 + np)
struct Block {
  const bf16* src;
  long long rs;                // row stride, elements
  signed char* dst;            // int8 rows, RB bytes apart
  float* scale;
  int row0, n, p0, np;
};

__device__ __forceinline__ Block block_rows(const QParams& p, int bh, int j) {
  const int b = bh / p.H, h = bh % p.H, qparts = p.ngroups * p.pq;
  if (j >= qparts) {
    const int row0 = (j - qparts) * PR;
    return {p.k + b * p.k_sb + h * p.k_sh, p.k_ss,
            p.kq + (long long)bh * p.S * p.RB, p.sk + bh, row0,
            min(PR, p.S - row0), qparts, p.pk};
  }
  const int g = j / p.pq, r0 = g * p.qblock;
  const int row0 = r0 + (j % p.pq) * PR;
  return {p.q + b * p.q_sb + h * p.q_sh, p.q_st,
          p.qq + (long long)bh * p.T * p.RB,
          p.sq + (long long)bh * p.ngroups + g, row0,
          min(PR, min(r0 + p.qblock, p.T) - row0), g * p.pq, p.pq};
}

// 8 values of row r from column c (a multiple of 8), zeros past D: one
// 16-byte load where the operands allow it (vec), else element by element
__device__ __forceinline__ uint4 load8(const QParams& p, const Block& bl,
                                       int r, int c) {
  const bf16* src = bl.src + r * bl.rs + c;
  if (p.vec) {
    return c < p.D ? *reinterpret_cast<const uint4*>(src)
                   : make_uint4(0, 0, 0, 0);
  }
  uint4 u;
  bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    e[j] = c + j < p.D ? src[j] : __float2bfloat16(0.f);
  return u;
}

__device__ __forceinline__ float amax8(const uint4& u) {
  const bf16* e = reinterpret_cast<const bf16*>(&u);
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(__bfloat162float(e[j])));
  return m;
}

// clip(round_half_even(x / s), +-127) of 8 values as 8 int8, with x / s
// as q + (x - q s) r, q = x r, r = RN(1 / s) (one reciprocal a block, a
// product and two FMAs a value, where a true division costs a slow
// sequence). That quotient can miss RN(x / s) by an ulp, but never so that
// the rounded int8 differs: `gill_flash_mma_q8_check_division` compares
// every bf16 x with |x| <= amax against every bf16 amax's scale
__device__ __forceinline__ uint2 quant8(const uint4& u, float s, float r) {
  const bf16* e = reinterpret_cast<const bf16*>(&u);
  unsigned w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float x = __bfloat162float(e[j]);
    const float q = __fmul_rn(x, r);
    const float qd = __fmaf_rn(__fmaf_rn(-q, s, x), r, q);
    const int v = max(-127, min(127, __float2int_rn(qd)));
    w[j / 4] |= (unsigned)(v & 0xff) << (8 * (j % 4));
  }
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ float block_max(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_max(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  return warp_max(lane < PT / 32 ? red[lane] : 0.f);
}

// grid (ngroups * pq + pk, B*H), level one: each block's amax (an empty
// part of a partial last q group writes 0)
__global__ void __launch_bounds__(PT) qk_amax(QParams p) {
  __shared__ float red[PT / 32];
  const Block bl = block_rows(p, blockIdx.y, blockIdx.x);
  const int n8 = p.RB / 8, total = max(bl.n, 0) * n8;
  float mx = 0.f;
  for (int i0 = 0; i0 < total; i0 += PT * U) {
    uint4 u[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int i = i0 + j * PT + threadIdx.x;
      u[j] = i < total ? load8(p, bl, bl.row0 + i / n8, (i % n8) * 8)
                       : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < U; ++j) mx = fmaxf(mx, amax8(u[j]));
  }
  mx = block_max(mx, red);
  if (threadIdx.x == 0)
    p.part[(long long)blockIdx.y * gridDim.x + blockIdx.x] = mx;
}

// the same grid, level two: the segment's block maxima, its scale
// max(amax / 127, 1e-12), and the block's rows as int8 (the padding to RB
// bytes included)
__global__ void __launch_bounds__(PT) qk_quantize(QParams p) {
  __shared__ float red[PT / 32];
  const Block bl = block_rows(p, blockIdx.y, blockIdx.x);
  if (bl.n <= 0) return;
  const float* part = p.part + (long long)blockIdx.y * gridDim.x + bl.p0;
  float mx = 0.f;
  for (int i = threadIdx.x; i < bl.np; i += PT) mx = fmaxf(mx, part[i]);
  mx = block_max(mx, red);
  const float s = fmaxf(__fdiv_rn(mx, 127.f), 1e-12f);
  const float r = __frcp_rn(s);
  if (blockIdx.x == bl.p0 && threadIdx.x == 0) *bl.scale = s;
  const int n8 = p.RB / 8, total = bl.n * n8;
  for (int i0 = 0; i0 < total; i0 += PT * U) {
    uint4 u[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int i = i0 + j * PT + threadIdx.x;
      u[j] = i < total ? load8(p, bl, bl.row0 + i / n8, (i % n8) * 8)
                       : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int i = i0 + j * PT + threadIdx.x;
      if (i < total)
        *reinterpret_cast<uint2*>(bl.dst +
                                  (long long)(bl.row0 + i / n8) * p.RB +
                                  (i % n8) * 8) = quant8(u[j], s, r);
    }
  }
}

// every bf16 x with |x| <= amax against every positive finite bf16 amax
// (one block each): quant8's int8 against the one of a true division
__global__ void __launch_bounds__(256)
    quant8_check(unsigned long long* mismatches) {
  const float amax = __bfloat162float(
      __ushort_as_bfloat16((unsigned short)(blockIdx.x + 1)));
  const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
  const float r = __frcp_rn(s);
  unsigned long long bad = 0;
  for (int x0 = threadIdx.x * 8; x0 < 65536; x0 += 256 * 8) {
    uint4 u;
    bf16* e = reinterpret_cast<bf16*>(&u);
    for (int j = 0; j < 8; ++j) {
      const bf16 x = __ushort_as_bfloat16((unsigned short)(x0 + j));
      e[j] = fabsf(__bfloat162float(x)) <= amax ? x : __float2bfloat16(0.f);
    }
    const uint2 w = quant8(u, s, r);
    for (int j = 0; j < 8; ++j) {
      const int want = max(-127, min(127, __float2int_rn(
                                              __fdiv_rn(__bfloat162float(e[j]), s))));
      const int got = (signed char)(((j < 4 ? w.x : w.y) >> (8 * (j % 4))) &
                                    0xff);
      bad += got != want;
    }
  }
  atomicAdd(mismatches, bad);
}

}  // namespace

// bf16 attention (K2 at head dims <= 80, K1 above). q, k, v bf16 with unit
// last strides and the strides given (elements); o a contiguous bf16 (B, T,
// H, D); D a multiple of 8 up to 512; (bq, bk) one of the tiles `dispatch`
// takes for D (`ops/attention.py` `flash_plan`). Returns a cudaError_t
// (0 = launched).
extern "C" int gill_flash_mma(const void* q, const void* k, const void* v,
                              void* o, int B, int T, int S, int H, int D,
                              long long q_sb, long long q_st, long long q_sh,
                              long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh,
                              float scale, int causal, int kv_len, int bq,
                              int bk, void* stream) {
  if (!aligned16(q, {q_sb, q_st, q_sh}) || !aligned16(k, {k_sb, k_ss, k_sh}) ||
      !aligned16(v, {v_sb, v_ss, v_sh}) || !aligned16(o, {}))
    return (int)cudaErrorMisalignedAddress;
  Params p{static_cast<const unsigned char*>(q),
           static_cast<const unsigned char*>(k),
           static_cast<const unsigned char*>(v),
           static_cast<unsigned char*>(o), nullptr, nullptr,
           B, T, S, H, D, kv_len, causal, 1, 1, D / 8,
           2 * q_sb, 2 * q_st, 2 * q_sh, 2 * k_sb, 2 * k_ss, 2 * k_sh,
           2 * v_sb, 2 * v_ss, 2 * v_sh, scale};
  return (int)dispatch<false>(p, bq, bk, static_cast<cudaStream_t>(stream));
}

// K10's pre-pass: q (B, T, H, D) and k (B, S, H, D) bf16 (unit last
// strides, the strides given in elements) -> qq (B*H, T, RB) and kq (B*H,
// S, RB) int8, RB = D rounded up to 16, sq (B*H, ceil(T / qblock)) and sk
// (B*H) fp32; part: fp32 scratch of B*H * (ceil(T / qblock) *
// ceil(min(qblock, T) / 64) + ceil(S / 64)) block maxima, nparts its size.
// Returns a cudaError_t.
extern "C" int gill_flash_mma_q8_prepass(
    const void* q, const void* k, void* qq, void* kq, void* sq, void* sk,
    void* part, long long nparts, int B, int T, int S, int H, int D,
    int qblock, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || D <= 0 || D > 128 ||
      qblock <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const int ngroups = (T + qblock - 1) / qblock;
  const int pq = (std::min(qblock, T) + PR - 1) / PR, pk = (S + PR - 1) / PR;
  const long long nblk = (long long)ngroups * pq + pk;
  if (nblk > 0x7fffffff || nparts < nblk * B * H)
    return (int)cudaErrorInvalidValue;
  const bool vec = D % 8 == 0 && aligned16(q, {q_sb, q_st, q_sh}) &&
                   aligned16(k, {k_sb, k_ss, k_sh});
  QParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<signed char*>(qq), static_cast<signed char*>(kq),
            static_cast<float*>(sq), static_cast<float*>(sk),
            static_cast<float*>(part), B, T, S, H, D, (D + 15) / 16 * 16,
            qblock, ngroups, pq, pk, (int)vec,
            q_sb, q_st, q_sh, k_sb, k_ss, k_sh};
  const dim3 grid((unsigned)nblk, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  qk_amax<<<grid, PT, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  qk_quantize<<<grid, PT, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// The pre-pass's quotient check (`quant8_check`): adds to *mismatches the
// pairs whose int8 differs from a true division's. Returns a cudaError_t.
extern "C" int gill_flash_mma_q8_check_division(void* mismatches,
                                                void* stream) {
  quant8_check<<<0x7F7F, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(mismatches));
  return (int)cudaGetLastError();
}

// int8-QK attention (K10) on the pre-pass's outputs: v bf16 with the
// strides given (elements), o a contiguous bf16 (B, T, H, D), D a
// multiple of 8 up to 128. Returns a cudaError_t.
extern "C" int gill_flash_mma_q8(const void* qq, const void* kq,
                                 const void* sq, const void* sk,
                                 const void* v, void* o, int B, int T, int S,
                                 int H, int D, int qblock, long long v_sb,
                                 long long v_ss, long long v_sh, float scale,
                                 int bq, int bk, void* stream) {
  if (!aligned16(v, {v_sb, v_ss, v_sh}) || !aligned16(o, {}) ||
      !aligned16(qq, {}) || !aligned16(kq, {}))
    return (int)cudaErrorMisalignedAddress;
  if (qblock <= 0) return (int)cudaErrorInvalidValue;
  const long long rb = (D + 15) / 16 * 16;
  Params p{static_cast<const unsigned char*>(qq),
           static_cast<const unsigned char*>(kq),
           static_cast<const unsigned char*>(v),
           static_cast<unsigned char*>(o), static_cast<const float*>(sq),
           static_cast<const float*>(sk),
           B, T, S, H, D, S, 0, qblock, (T + qblock - 1) / qblock,
           (int)(rb / 16),
           rb * T * H, rb, rb * T, rb * S * H, rb, rb * S,
           2 * v_sb, 2 * v_ss, 2 * v_sh, scale};
  return (int)dispatch<true>(p, bq, bk, static_cast<cudaStream_t>(stream));
}
