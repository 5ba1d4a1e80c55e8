// Parameterised flash-attention variants for Hopper (sm_90a), bf16 in and
// out: the attention sweep's single-pass, online and no-max kernels, each
// a mode of one mma.sync kernel.
//
// Replaces scripts/attn_sweep.py
//  * `make_flash(block_q, block_k, prob_dtype, kt)` (Pallas kernel at :43,
//    pallas_call at :104), S2: softmax(q k^T / sqrt(D)) v with the
//    probabilities' dtype and k's layout as parameters. One key block
//    (block_k = S) is single-pass: the row max over every key is taken
//    before any exp, with no rescale. Smaller block_k is online: a running
//    max with the alpha rescale. With kt, k arrives as (B*H, D, S);
//  * `make_flash_nomax(block_q, block_k)` (Pallas kernel at :128,
//    pallas_call at :171), S3: p = exp(s - 12) in fp32, no max and no
//    clamp (scores above ~100 overflow, as in the original), l and P.V in
//    fp32.
// Both end in acc / max(l, 1e-30), rounded once to bf16. Non-causal.
//
// Rounding points, each mode against the original (s = fp32(q . k), the
// unscaled sum of the mma; c = scale * log2(e) in fp32):
//  * fp32 probabilities (single-pass, online, no-max): the original's
//    p = exp(fp32(s * scale) - m) is folded into p = ex2(fma(s, c, -m2))
//    with the row max kept as m2 = max(s) * c (no-max: m2 = 12 * log2(e)):
//    one FMA into ex2.approx, which moves p by a few fp32 ulps, far under
//    the two-bf16-ulp output tolerance. l sums the fp32 p; P.V takes p
//    rounded to bf16, as the original;
//  * bf16 probabilities: the variant is its rounding point, so it is kept:
//    x = bf16(fp32(fp32(s * scale) - m)) in natural-log units with m =
//    fp32(max(s) * scale), then p = bf16(2^(x * log2(e))); l sums the bf16
//    p in fp32 and P.V takes them as they are. (Folding the rounding into
//    the log2 domain would round another number.)
//  * online rescales at the kernel's own BK-key tiles where the original
//    rescales every block_k keys: the two differ only in where p rounds to
//    bf16 against the running max and in fp32 rounding, per-key differences
//    of a bf16 ulp that average out over the keys, far under the output
//    tolerance.
// Keys past S take -inf, so they contribute exactly 0 in every mode (also
// in no-max, where ex2(-inf) = 0); a no-max score past ~100 gives
// ex2 = +inf, and its row comes out non-finite, as in the original.
//
// Layout: q and v (B, T|S, H, D) with their own batch, row and head strides
// and a unit last stride; k with four strides (batch, key, head, depth), one
// of the last two 1: (B, S, H, D) or, with kt, (B*H, D, S); out a contiguous
// (B, T, H, D). The TPU's lane padding of D to 128 is not ported: D is a
// multiple of 8, at most 48, and is a template parameter (NC = D / 8
// 16-byte chunks); nothing is zero-padded. Operands, their strides and
// (with kt) S are 8-element aligned.
//
// What bounds it on an H100 (132 SMs, 989 TFLOP/s bf16, ~3.9e12
// exponentials/s on the special-function units): at the sweep's shape (B 8,
// H 8, T = S = 4096, D 40) 1.07e9 exponentials take >= 0.275 ms, the
// products 0.17 ms at the full tensor rate: the exponentials bind (the
// single-pass mode's second QK^T sweep adds products, not exponentials).
// The design is K2's (csrc/flash_mma.cu, the FlashAttention-2 shape):
//  * one block = BQ query rows of one (b, h), one warp per 16 rows; Q is
//    loaded once into registers as mma.sync A fragments (ldmatrix);
//  * S = Q K^T on mma.sync m16n8k16 (bf16, fp32 sums) into registers, 16 x
//    BK a warp, never stored; an odd NC (D 8, 24, 40) ends in one m16n8k8
//    step. With kt the K tile is [depth][key] and its B fragments come
//    through ldmatrix.trans;
//  * the softmax runs on those registers: a row's max over the quad of
//    lanes that own it (shuffles 1 and 2), each lane's part taken as a tree
//    (log2 of the tile's dependent steps, not one a column), exponentials
//    on ex2.approx; fp32 row sums kept per lane (a tree a tile) and reduced
//    once at the end; bf16 ones summed by the tensor cores as P . 1 (one
//    more m16n8k16 a 16 keys, whose every column is the rows' sum), which
//    takes the unpacking and adds off the CUDA cores;
//  * P goes to bf16 in registers and is the A operand of P.V as it stands;
//    V is the B operand through ldmatrix.trans; O, 16 x D fp32 a warp,
//    stays in registers from the first key tile to the epilogue;
//  * K/V tiles stream through a two-stage cp.async ring with one block
//    barrier per key tile (tile j + 1 in flight while tile j is computed),
//    the key edge zero-filled by the copies' source size; row strides are
//    odd numbers of 16-byte chunks, so ldmatrix is conflict-free;
//  * single-pass is two sweeps over the keys in one loop: sweep 1 runs
//    Q K^T and the max only (no V through the ring; at BQ 128 two K tiles
//    a step, the second in the stage's V slot: half the barriers, twice the
//    independent products a step), sweep 2 the exponentials and P.V
//    against that fixed max with no rescale. Both compute each score with
//    the same instructions in the same order (one function), so sweep 2
//    never sees a score above sweep 1's max;
//  * online keeps a running max and rescales O in registers every BK keys;
//    no-max runs one sweep with the shift fixed at 12;
//  * the epilogue divides by max(l, 1e-30), stages the warp's bf16 rows in
//    its own slab of the Q tile and writes them with 16-byte stores.
// The mode is a block-uniform runtime branch; NC, the tile (BQ, BK), kt and
// the probabilities' dtype are template parameters (72 kernels; a runtime
// dtype branch would sit between the exponentials and P.V). Tiles: 64 x 64,
// 128 x 64 and 64 x 128 (BQ x BK) for the TPU's block_q of <= 256, 512 and
// >= 1024. A 128 x 128 tile holds S in 64 registers a lane, which left one
// block of eight warps an SM, and was slower than 64 x 128 on the H100 at
// the sweep's shape.
// The launch geometry is `plan_for`'s, mirrored by ops/flash_variants.py
// `variant_plan`; the entry point refuses any other.

#include <initializer_list>

#include "common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float NOMAX_SHIFT = 12.f;  // the no-max kernel's fixed shift
constexpr int MAX_D = 48;
constexpr int STAGES = 2;            // the K/V ring

enum Mode { SINGLE = 0, ONLINE = 1, NOMAX = 2 };

struct Params {
  const unsigned char* q;
  const unsigned char* k;
  const unsigned char* v;
  unsigned char* o;                  // bf16 (B, T, H, D)
  int B, T, S, H, D, mode, bf16_probs;
  // strides in bytes
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, k_sd, v_sb, v_ss, v_sh;
  float scale;
};

__host__ __device__ constexpr int odd_up(int n) { return n | 1; }

// shared-memory bytes of the Q tile (also the epilogue's staging) and of
// one ring stage's K and V slots, for NC chunks of depth; the V slot holds
// a second K tile in the single-pass mode's first sweep
constexpr int q_bytes(int nc, int bq) { return bq * odd_up(nc) * 16; }
constexpr int k_bytes(int nc, int bk, bool kt) {
  return kt ? 8 * nc * odd_up(bk / 8) * 16 : bk * odd_up(nc) * 16;
}
constexpr int v_bytes(int nc, int bk, bool kt) {
  return k_bytes(nc, bk, kt) > bk * odd_up(nc) * 16 ? k_bytes(nc, bk, kt)
                                                    : bk * odd_up(nc) * 16;
}
constexpr int smem_bytes(int nc, int bq, int bk, bool kt) {
  return q_bytes(nc, bq) + STAGES * (k_bytes(nc, bk, kt) + v_bytes(nc, bk, kt));
}

template <int NC, int BQ, int BK, bool KT> struct Cfg {
  static constexpr int NTH = BQ / 16 * 32;
  static constexpr int NFULL = NC / 2;             // k16 steps of Q K^T
  static constexpr bool TAIL = NC % 2 == 1;        // and one k8 step
  // shared row strides in 16-byte chunks, odd: the 8 rows an ldmatrix
  // reads fall in 8 different bank groups. LQ: Q, V and (not kt) K rows of
  // D; LKT: kt's K rows of BK keys
  static constexpr int LQ = odd_up(NC), LKT = odd_up(BK / 8);
  static constexpr int Q_BYTES = q_bytes(NC, BQ);
  static constexpr int K_BYTES = k_bytes(NC, BK, KT);
  static constexpr int V_BYTES = v_bytes(NC, BK, KT);
  static constexpr int SMEM = smem_bytes(NC, BQ, BK, KT);
  // single-pass's first sweep takes two K tiles a step where a block has
  // eight warps (two blocks an SM leave a tile's latency in the open); at
  // BQ 64 (three to five blocks an SM) the pair costs registers only
  static constexpr bool PAIR = BQ == 128;
  static_assert(NC >= 1 && NC * 8 <= MAX_D && BK % 16 == 0 && BQ % 16 == 0,
                "tile");
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

// the two bf16 halves of a packed pair, as fp32
__device__ __forceinline__ float bf_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// v[0] op v[1] op ... as a tree (N a power of two): log2(N) dependent
// steps where a running value would take N
template <int N, typename F>
__device__ __forceinline__ float tree(float (&v)[N], F op) {
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) v[i] = op(v[i], v[i + w]);
  return v[0];
}

// the maxima of this lane's parts of its two rows in a (16, 8 NT) score tile
template <int NT>
__device__ __forceinline__ void row_max(const float (&s)[NT][4], float& lo,
                                        float& hi) {
  float a[NT], b[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    a[n] = fmaxf(s[n][0], s[n][1]);
    b[n] = fmaxf(s[n][2], s[n][3]);
  }
  const auto mx = [](float x, float y) { return fmaxf(x, y); };
  lo = tree(a, mx);
  hi = tree(b, mx);
}

constexpr unsigned BF16_ONES = 0x3f803f80u;   // (1.0, 1.0) as bf16x2

// S = Q K^T of one K tile (keys [k0, k0 + BK)): (16, BK) a warp, in
// registers, keys at or past S set to -inf. Q as A fragments (qa: the k16
// steps, qt: the k8 tail); the tile [key][depth], or [depth][key] with KT
template <int NC, int BK, bool KT>
__device__ __forceinline__ void qk_scores(
    float (&s)[BK / 8][4], const unsigned (&qa)[NC / 2 > 0 ? NC / 2 : 1][4],
    const unsigned (&qt)[2], const unsigned char* kst, int k0, int S,
    int lane) {
  constexpr int NFULL = NC / 2, LQ = odd_up(NC), LKT = odd_up(BK / 8);
  const int mi = lane >> 3, mr = lane & 7, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int st = 0; st < NFULL; ++st) {
      unsigned bm[4];
      if constexpr (KT)
        ldsm_x4_t(bm, kst + ((st * 16 + (mi & 1) * 8 + mr) * LKT + 2 * kk +
                             (mi >> 1)) * 16);
      else
        ldsm_x4(bm, kst + ((kk * 16 + (mi >> 1) * 8 + mr) * LQ + 2 * st +
                           (mi & 1)) * 16);
      mma_bf16_k16(s[2 * kk], qa[st], bm[0], bm[1]);
      mma_bf16_k16(s[2 * kk + 1], qa[st], bm[2], bm[3]);
    }
    if constexpr (NC % 2 == 1) {
      unsigned bm[2];
      if constexpr (KT)
        ldsm_x2_t(bm, kst + ((NFULL * 16 + mr) * LKT + 2 * kk + (mi & 1)) *
                                16);
      else
        ldsm_x2(bm, kst + ((kk * 16 + (mi & 1) * 8 + mr) * LQ + NC - 1) * 16);
      mma_bf16_k8(s[2 * kk], qt, bm[0]);
      mma_bf16_k8(s[2 * kk + 1], qt, bm[1]);
    }
  }
  if (k0 + BK > S) {   // only the last tile
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * n + 2 * t4 + (e & 1) >= S) s[n][e] = -INFINITY;
  }
}

template <int NC, int BQ, int BK, bool KT, bool BF>
__global__ void __launch_bounds__(Cfg<NC, BQ, BK, KT>::NTH)
    flash_variant(const Params p) {
  using C = Cfg<NC, BQ, BK, KT>;
  constexpr int NTH = C::NTH, NFULL = C::NFULL, LQ = C::LQ, LKT = C::LKT;
  constexpr int NT = BK / 8;                     // n8 tiles of a score row
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;
  unsigned char* ks = qs + C::Q_BYTES;
  unsigned char* vs = ks + STAGES * C::K_BYTES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;        // mma fragment row / pair
  const int mi = lane >> 3, mr = lane & 7;       // ldmatrix matrix / row
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;
  const unsigned char* kg = p.k + b * p.k_sb + h * p.k_sh;
  const unsigned char* vg = p.v + b * p.v_sb + h * p.v_sh;
  const int nkt = (p.S + BK - 1) / BK;
  // single-pass: steps [0, vfrom) are sweep 1, one K tile a step or, with
  // PAIR, two (the second in the V slot); [vfrom, vfrom + nkt) sweep 2, a K
  // and a V tile a step
  constexpr bool PAIR = C::PAIR;
  const int mode = p.mode;
  const int vfrom = mode == SINGLE ? (PAIR ? (nkt + 1) / 2 : nkt) : 0;
  const int nsteps = vfrom + nkt;

  // the K tile of keys [k1, k1 + BK) into a slot, zero-filled past S
  auto load_k = [&](unsigned char* dst, int k1) {
    const int nk = min(BK, p.S - k1);
    if constexpr (KT)   // rows = depth, chunks = 8 keys (S % 8 == 0)
      load_tile<8 * NC, BK / 8, LKT, NTH>(dst, kg + k1 * p.k_ss, p.k_sd,
                                          8 * NC, nk / 8, tid);
    else
      load_tile<BK, NC, LQ, NTH>(dst, kg + k1 * p.k_ss, p.k_ss, nk, NC, tid);
  };
  // a step's tiles into its ring stage
  auto fetch = [&](int step) {
    unsigned char* kd = ks + (step % STAGES) * C::K_BYTES;
    unsigned char* vd = vs + (step % STAGES) * C::V_BYTES;
    if (step < vfrom) {
      load_k(kd, (PAIR ? 2 * step : step) * BK);
      if (PAIR) load_k(vd, (2 * step + 1) * BK);
    } else {
      const int k1 = (step - vfrom) * BK;
      load_k(kd, k1);
      load_tile<BK, NC, LQ, NTH>(vd, vg + k1 * p.v_ss, p.v_ss,
                                 min(BK, p.S - k1), NC, tid);
    }
  };

  load_tile<BQ, NC, LQ, NTH>(qs, p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_st,
                             p.q_st, min(BQ, p.T - q0), NC, tid);
  fetch(0);
  cp_async_commit();
  cp_async_wait_prior<0>();
  __syncthreads();

  // this warp's 16 rows of Q as A fragments, for the whole key loop
  const int r0 = warp * 16;
  unsigned qa[NFULL > 0 ? NFULL : 1][4], qt[2];
#pragma unroll
  for (int st = 0; st < NFULL; ++st)
    ldsm_x4(qa[st], qs + ((r0 + (mi & 1) * 8 + mr) * LQ + 2 * st + (mi >> 1)) *
                             16);
  if constexpr (C::TAIL)
    ldsm_x2(qt, qs + ((r0 + (mi & 1) * 8 + mr) * LQ + NC - 1) * 16);

  const float c = p.scale * LOG2E;
  float o[NC][4];
#pragma unroll
  for (int i = 0; i < NC; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // the rows' (g and g + 8) shift: log2 units with fp32 probabilities,
  // natural ones with bf16
  float m_lo = -INFINITY, m_hi = -INFINITY;
  if (mode == NOMAX) m_lo = m_hi = NOMAX_SHIFT * LOG2E;
  // the row sums: fp32 probabilities per lane (the quad's parts summed at
  // the end); bf16 ones as P . 1 on the tensor cores, an m16n8 C tile whose
  // every column holds the rows' whole sums
  float l_lo = 0.f, l_hi = 0.f;
  float lt[4] = {0.f, 0.f, 0.f, 0.f};
  float x_lo = -INFINITY, x_hi = -INFINITY;      // sweep 1's lane maxima

  for (int step = 0; step < nsteps; ++step) {
    if (step > 0) {
      cp_async_wait_prior<0>();   // this step's tile has landed
      __syncthreads();            // for every warp; and the last is read
    }
    if (step + 1 < nsteps) fetch(step + 1);
    cp_async_commit();
    const unsigned char* kst = ks + (step % STAGES) * C::K_BYTES;
    const unsigned char* vst = vs + (step % STAGES) * C::V_BYTES;

    if (step < vfrom) {   // single-pass sweep 1: the rows' max only
      float s[NT][4], t_lo, t_hi;
      qk_scores<NC, BK, KT>(s, qa, qt, kst, (PAIR ? 2 * step : step) * BK,
                            p.S, lane);
      if constexpr (PAIR) {
        // the second tile's scores (all -inf past S) before either max
        float s2[NT][4], t2_lo, t2_hi;
        qk_scores<NC, BK, KT>(s2, qa, qt, vst, (2 * step + 1) * BK, p.S,
                              lane);
        row_max(s, t_lo, t_hi);
        row_max(s2, t2_lo, t2_hi);
        t_lo = fmaxf(t_lo, t2_lo);
        t_hi = fmaxf(t_hi, t2_hi);
      } else {
        row_max(s, t_lo, t_hi);
      }
      x_lo = fmaxf(x_lo, t_lo);
      x_hi = fmaxf(x_hi, t_hi);
      if (step == vfrom - 1) {
#pragma unroll
        for (int sh = 1; sh <= 2; sh <<= 1) {
          x_lo = fmaxf(x_lo, __shfl_xor_sync(0xffffffffu, x_lo, sh));
          x_hi = fmaxf(x_hi, __shfl_xor_sync(0xffffffffu, x_hi, sh));
        }
        // rounding is monotonic: max(fp32(s * a)) = fp32(max(s) * a)
        m_lo = BF ? __fmul_rn(x_lo, p.scale) : x_lo * c;
        m_hi = BF ? __fmul_rn(x_hi, p.scale) : x_hi * c;
      }
      continue;
    }

    float s[NT][4];
    qk_scores<NC, BK, KT>(s, qa, qt, kst, (step - vfrom) * BK, p.S, lane);
    if (mode == ONLINE) {   // the running max and the alpha rescale
      float mx_lo, mx_hi;
      row_max(s, mx_lo, mx_hi);
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, sh));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, sh));
      }
      const float mn_lo = fmaxf(m_lo, BF ? __fmul_rn(mx_lo, p.scale)
                                         : mx_lo * c);
      const float mn_hi = fmaxf(m_hi, BF ? __fmul_rn(mx_hi, p.scale)
                                         : mx_hi * c);
      // the first tile holds key 0, so mn is finite and alpha(-inf) = 0
      const float a_lo = BF ? ex2(__fmul_rn(__fsub_rn(m_lo, mn_lo), LOG2E))
                            : ex2(m_lo - mn_lo);
      const float a_hi = BF ? ex2(__fmul_rn(__fsub_rn(m_hi, mn_hi), LOG2E))
                            : ex2(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      if constexpr (BF) {
        lt[0] *= a_lo;
        lt[1] *= a_lo;
        lt[2] *= a_hi;
        lt[3] *= a_hi;
      } else {
        l_lo *= a_lo;
        l_hi *= a_hi;
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        o[i][0] *= a_lo;
        o[i][1] *= a_lo;
        o[i][2] *= a_hi;
        o[i][3] *= a_hi;
      }
    }

    // P, packed to bf16 pairs as P.V's A fragments
    unsigned pp[NT][2];
    if constexpr (BF) {
      // x = bf16(fp32(s * scale) - m), p = bf16(exp(x)) as ex2(x log2 e);
      // their sum comes with P . V
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const unsigned x01 =
            pack_bf16(__fsub_rn(__fmul_rn(s[n][0], p.scale), m_lo),
                      __fsub_rn(__fmul_rn(s[n][1], p.scale), m_lo));
        const unsigned x23 =
            pack_bf16(__fsub_rn(__fmul_rn(s[n][2], p.scale), m_hi),
                      __fsub_rn(__fmul_rn(s[n][3], p.scale), m_hi));
        pp[n][0] = pack_bf16(ex2(__fmul_rn(bf_lo(x01), LOG2E)),
                             ex2(__fmul_rn(bf_hi(x01), LOG2E)));
        pp[n][1] = pack_bf16(ex2(__fmul_rn(bf_lo(x23), LOG2E)),
                             ex2(__fmul_rn(bf_hi(x23), LOG2E)));
      }
    } else {
      // p = exp(s * scale - m) as ex2(fma(s, c, -m2))
      float sum_lo[NT], sum_hi[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float p0 = ex2(fmaf(s[n][0], c, -m_lo));
        const float p1 = ex2(fmaf(s[n][1], c, -m_lo));
        const float p2 = ex2(fmaf(s[n][2], c, -m_hi));
        const float p3 = ex2(fmaf(s[n][3], c, -m_hi));
        sum_lo[n] = p0 + p1;
        sum_hi[n] = p2 + p3;
        pp[n][0] = pack_bf16(p0, p1);
        pp[n][1] = pack_bf16(p2, p3);
      }
      const auto add = [](float x, float y) { return x + y; };
      l_lo += tree(sum_lo, add);
      l_hi += tree(sum_hi, add);
    }

    // O += P V: P's C tiles 2kk and 2kk + 1 are the A tile of keys
    // [16kk, 16kk + 16); V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned a[4] = {pp[2 * kk][0], pp[2 * kk][1], pp[2 * kk + 1][0],
                             pp[2 * kk + 1][1]};
#pragma unroll
      for (int dp = 0; dp < NC / 2; ++dp) {
        unsigned bm[4];
        ldsm_x4_t(bm, vst + ((kk * 16 + (mi & 1) * 8 + mr) * LQ + 2 * dp +
                             (mi >> 1)) * 16);
        mma_bf16_k16(o[2 * dp], a, bm[0], bm[1]);
        mma_bf16_k16(o[2 * dp + 1], a, bm[2], bm[3]);
      }
      if constexpr (NC % 2 == 1) {
        unsigned bm[2];
        ldsm_x2_t(bm, vst + ((kk * 16 + (mi & 1) * 8 + mr) * LQ + NC - 1) * 16);
        mma_bf16_k16(o[NC - 1], a, bm[0], bm[1]);
      }
      if constexpr (BF) mma_bf16_k16(lt, a, BF16_ONES, BF16_ONES);
    }
  }

  // epilogue: the quad's row sums, O / max(l, 1e-30) to bf16 through this
  // warp's own rows of the Q tile (it has read its Q fragments), then
  // 16-byte stores
  if constexpr (BF) {
    l_lo = lt[0];
    l_hi = lt[2];
  } else {
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, sh);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, sh);
    }
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  unsigned char* slab = qs + r0 * LQ * 16;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    *reinterpret_cast<unsigned*>(slab + (g * LQ + i) * 16 + t4 * 4) =
        pack_bf16(o[i][0] * inv_lo, o[i][1] * inv_lo);
    *reinterpret_cast<unsigned*>(slab + ((g + 8) * LQ + i) * 16 + t4 * 4) =
        pack_bf16(o[i][2] * inv_hi, o[i][3] * inv_hi);
  }
  __syncwarp();
  const long long orow = (long long)p.H * p.D * 2;
  unsigned char* og = p.o + ((long long)b * p.T * p.H + h) * p.D * 2;
  for (int i = lane; i < 16 * NC; i += 32) {
    const int r = i / NC, cc = i - (i / NC) * NC, qr = q0 + r0 + r;
    if (qr < p.T)
      *reinterpret_cast<uint4*>(og + qr * orow + cc * 16) =
          *reinterpret_cast<const uint4*>(slab + (r * LQ + cc) * 16);
  }
}

template <int NC, int BQ, int BK, bool KT, bool BF>
cudaError_t launch(const Params& p, cudaStream_t st) {
  using C = Cfg<NC, BQ, BK, KT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_variant<NC, BQ, BK, KT, BF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.T + BQ - 1) / BQ, p.B * p.H);
  flash_variant<NC, BQ, BK, KT, BF><<<grid, C::NTH, C::SMEM, st>>>(p);
  return cudaGetLastError();
}

template <int NC, int BQ, int BK, bool KT>
cudaError_t by_probs(const Params& p, cudaStream_t st) {
  return p.bf16_probs ? launch<NC, BQ, BK, KT, true>(p, st)
                      : launch<NC, BQ, BK, KT, false>(p, st);
}

template <int NC, bool KT>
cudaError_t by_tile(const Params& p, int bq, int bk, cudaStream_t st) {
  if (bq == 64 && bk == 64) return by_probs<NC, 64, 64, KT>(p, st);
  if (bq == 128 && bk == 64) return by_probs<NC, 128, 64, KT>(p, st);
  if (bq == 64 && bk == 128) return by_probs<NC, 64, 128, KT>(p, st);
  return cudaErrorInvalidValue;
}

template <bool KT>
cudaError_t by_dim(const Params& p, int bq, int bk, cudaStream_t st) {
  switch (p.D / 8) {
    case 1: return by_tile<1, KT>(p, bq, bk, st);
    case 2: return by_tile<2, KT>(p, bq, bk, st);
    case 3: return by_tile<3, KT>(p, bq, bk, st);
    case 4: return by_tile<4, KT>(p, bq, bk, st);
    case 5: return by_tile<5, KT>(p, bq, bk, st);
    case 6: return by_tile<6, KT>(p, bq, bk, st);
  }
  return cudaErrorInvalidValue;
}

struct Plan {
  int bq, bk, k16, k8, stages, smem, grid_x, grid_y;
};

// the launch of a variant (mirrored by ops/flash_variants.py
// `variant_plan`): the Hopper tile for the TPU's block_q (256 and less 64
// x 64, up to 512 128 x 64, more 64 x 128), D / 8 chunks of depth as k16 steps
// and a k8 tail, the ring, shared memory and grid; false when the kernel
// does not take the call
bool plan_for(int B, int T, int S, int H, int D, int mode, int bf16_probs,
              int kt, int block_q, Plan* pl) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || D <= 0 || D > MAX_D || D % 8 ||
      mode < SINGLE || mode > NOMAX || (bf16_probs != 0 && bf16_probs != 1) ||
      (kt != 0 && kt != 1) || (long long)B * H > 65535 || block_q <= 0 ||
      T % block_q || (kt && S % 8) ||
      (mode == NOMAX && (bf16_probs || kt)))   // S3 has neither option
    return false;
  const int bq = block_q > 256 && block_q <= 512 ? 128 : 64;
  const int bk = block_q <= 512 ? 64 : 128;
  const int nc = D / 8;
  *pl = Plan{bq, bk, nc / 2, nc % 2, STAGES,
             smem_bytes(nc, bq, bk, kt != 0),
             (T + bq - 1) / bq, B * H};
  return true;
}

}  // namespace

// The plan of a call, as plan_for gives it: out = (bq, bk, k16 steps, k8
// tail, stages, shared-memory bytes, grid x, grid y). Returns a cudaError_t
// (an invalid value where the kernel does not take the call).
extern "C" int gill_flash_variant_plan(int B, int T, int S, int H, int D,
                                       int mode, int bf16_probs, int kt,
                                       int block_q, int* out) {
  Plan pl;
  if (!plan_for(B, T, S, H, D, mode, bf16_probs, kt, block_q, &pl))
    return (int)cudaErrorInvalidValue;
  const int v[8] = {pl.bq, pl.bk, pl.k16, pl.k8, pl.stages, pl.smem,
                    pl.grid_x, pl.grid_y};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// q, v (B, T|S, H, D) bf16 with unit last strides; k bf16 with strides
// (k_sb, k_ss, k_sh, k_sd), k_sd = 1 (kt = 0) or k_ss = 1 (kt = 1); strides
// in elements; o a contiguous bf16 (B, T, H, D); q, k, v, o 16-byte aligned
// with strides of 8-element multiples. mode: 0 single-pass, 1 online, 2
// no-max. (bq, bk, stages, smem) must be the plan gill_flash_variant_plan
// gives for (B, T, S, H, D, mode, bf16_probs, kt, block_q). One launch.
// Returns a cudaError_t (0 = launched; an invalid value for any other plan).
extern "C" int gill_flash_variant(
    const void* q, const void* k, const void* v, void* o, int B, int T,
    int S, int H, int D, int mode, int bf16_probs, int kt, int block_q,
    int bq, int bk, int stages, int smem, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long k_sd, long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  Plan pl;
  if (!plan_for(B, T, S, H, D, mode, bf16_probs, kt, block_q, &pl) ||
      pl.bq != bq || pl.bk != bk || pl.stages != stages || pl.smem != smem ||
      (kt ? k_ss : k_sd) != 1)
    return (int)cudaErrorInvalidValue;
  const long long kc = kt ? k_sd : k_ss;   // k's row stride in its tile
  for (long long s : {q_sb, q_st, q_sh, k_sb, kc, k_sh, v_sb, v_ss, v_sh})
    if (s % 8) return (int)cudaErrorInvalidValue;
  for (const void* ptr : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16)
      return (int)cudaErrorMisalignedAddress;
  Params p{static_cast<const unsigned char*>(q),
           static_cast<const unsigned char*>(k),
           static_cast<const unsigned char*>(v),
           static_cast<unsigned char*>(o), B, T, S, H, D, mode, bf16_probs,
           2 * q_sb, 2 * q_st, 2 * q_sh, 2 * k_sb, 2 * k_ss, 2 * k_sh,
           2 * k_sd, 2 * v_sb, 2 * v_ss, 2 * v_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(kt ? by_dim<true>(p, bq, bk, st) : by_dim<false>(p, bq, bk, st));
}
