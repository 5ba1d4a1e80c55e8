// Parameterised flash-attention variants for Hopper (sm_90a), bf16 in and
// out: the attention sweep's single-pass, online and no-max kernels.
//
// Replaces scripts/attn_sweep.py
//  * `make_flash(block_q, block_k, prob_dtype, kt)` (Pallas kernel at :43,
//    pallas_call at :104), S2: softmax(q k^T / sqrt(D)) v with the
//    probabilities' dtype and k's layout as parameters. One key block
//    (block_k = S) is single-pass: the row max over every key is taken
//    before any exp, with no rescale. Smaller block_k is online: a running
//    max with the alpha rescale. With bf16 probabilities, p = exp of the
//    bf16-rounded s - m, in bf16; l sums p in fp32 and P.V takes p as bf16.
//    With fp32 probabilities, l sums the fp32 p and P.V takes p rounded to
//    bf16. With kt, k arrives as (B*H, D, S);
//  * `make_flash_nomax(block_q, block_k)` (Pallas kernel at :128,
//    pallas_call at :171), S3: p = exp(s - 12) in fp32, no max and no
//    clamp (scores above ~100 overflow, as in the original), l and P.V in
//    fp32, out = acc / max(l, 1e-30).
// s = fp32(q . k) * (1 / sqrt(D)), rounded as the original rounds it; the
// output is rounded once to bf16 from acc / max(l, 1e-30). Non-causal.
//
// Layout: q and v (B, T|S, H, D) with their own batch, row and head strides
// and a unit last stride; k with four strides (batch, key, head, depth), one
// of the last two 1: (B, S, H, D) or, with kt, (B*H, D, S); out a contiguous
// (B, T, H, D). The TPU's lane padding of D to 128 is not ported: D (a
// multiple of 8, at most 48; the sweep's is 40) is zero-filled in shared
// memory to DP = 48, a multiple of 16. Every tile is loaded 16 bytes at a
// time, so the operands, their strides and (with kt) S are 8-element
// aligned.
//
// What bounds it on an H100: at the sweep's shape (B 8, H 8, T = S = 4096,
// D 40) about 4 T S D operations a head against 4 (T + S) D bytes, so it is
// compute-bound: both products belong on the tensor cores, and the exp and
// the row reductions on the CUDA cores are what remain. The TPU's block_q of
// 256-1024 rows and block_k = S = 4096 are sized for VMEM: a (block_q,
// 4096) fp32 score tile is 4-16 MB, which an SM cannot hold. So the Hopper
// tile is a template parameter, BQ in {64, 128} query rows a block (one warp
// per 16 rows) and BK in {64, 128} keys a step:
//  * single-pass becomes two sweeps over the keys: the first finds each
//    row's exact max (scores only), the second computes exp and P.V with no
//    rescale. That is the single-pass function exactly;
//  * online rescales at the kernel's own BK-key tile boundaries where the
//    original rescales every block_k keys. The two differ only in where p
//    is rounded to bf16 relative to the running max and in fp32 rounding:
//    per-key differences of an ulp of bf16 that average out over the keys,
//    far under the bf16 output tolerance;
//  * no-max is one sweep.
// The scores go through WMMA 16x16x16 bf16 with fp32 sums into shared
// memory, the softmax runs on lane pairs (one row each), and O += P.V on
// WMMA with the output fragments held in registers (the online rescale
// round-trips them through the warp's shared-memory strip). cp.async
// pipelining and wgmma are later work.

#include <mma.h>

#include <initializer_list>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr float NEG = -1e30f;        // the original's _NEG_INF
constexpr float NOMAX_SHIFT = 12.f;  // the no-max kernel's fixed shift
constexpr int DP = 48;               // D zero-filled to a multiple of 16

enum Mode { SINGLE = 0, ONLINE = 1, NOMAX = 2 };

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int B, T, S, H, D, mode, bf16_probs;
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, k_sd, v_sb, v_ss, v_sh;
  float scale;
};

constexpr size_t a128(size_t n) { return (n + 127) / 128 * 128; }

template <int BQ, int BK, bool KT> struct Lay {
  static constexpr int NW = BQ / 16, NTH = NW * 32;
  static constexpr int LQ = DP + 8;                 // bf16 row strides
  static constexpr int LK = KT ? BK + 8 : DP + 8;
  static constexpr int KROWS = KT ? DP : BK;
  static constexpr int LV = DP + 8;
  static constexpr int LS = BK + 4;                 // fp32 scores
  static constexpr int LP = BK + 8;                 // bf16 probabilities
  static constexpr int LO = DP + 4;                 // fp32 output staging
  static constexpr size_t q = 0;
  static constexpr size_t k = q + a128(2 * BQ * LQ);
  static constexpr size_t v = k + a128(2 * KROWS * LK);
  static constexpr size_t s = v + a128(2 * BK * LV);
  static constexpr size_t p = s + a128(4 * BQ * LS);
  static constexpr size_t o = p + a128(2 * BQ * LP);
  static constexpr size_t total = o + 4 * BQ * LO;
};

// ROWS x COLS bf16 tile (row stride ld) <- the matrix at src (row stride
// rs, unit column stride) in 16-byte loads (src, rs and nc 8-element
// aligned); rows >= nr and cols >= nc read as zeros
template <int ROWS, int COLS, int NTH>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long rs, int nr, int nc, int tid) {
  for (int i = tid; i < ROWS * (COLS / 8); i += NTH) {
    const int r = i / (COLS / 8), c = (i % (COLS / 8)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < nr && c < nc) x = *reinterpret_cast<const uint4*>(src + r * rs + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
  }
}

template <int BQ, int BK, bool KT>
__global__ void __launch_bounds__(BQ / 16 * 32) flash_variant(Params p) {
  using L = Lay<BQ, BK, KT>;
  constexpr int NTH = L::NTH;
  extern __shared__ __align__(128) unsigned char smem_fv[];
  bf16* qs = reinterpret_cast<bf16*>(smem_fv + L::q);
  bf16* ks = reinterpret_cast<bf16*>(smem_fv + L::k);
  bf16* vs = reinterpret_cast<bf16*>(smem_fv + L::v);
  float* ss = reinterpret_cast<float*>(smem_fv + L::s);
  bf16* ps = reinterpret_cast<bf16*>(smem_fv + L::p);
  float* os = reinterpret_cast<float*>(smem_fv + L::o);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;
  const bf16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vg = p.v + b * p.v_sb + h * p.v_sh;
  load_tile<BQ, DP, NTH>(qs, L::LQ, p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_st,
                         p.q_st, p.T - q0, p.D, tid);

  const int r0 = warp * 16;              // this warp's 16 query rows
  float* my_s = ss + r0 * L::LS;
  bf16* my_p = ps + r0 * L::LP;
  float* my_o = os + r0 * L::LO;
  const int row = lane >> 1, half = lane & 1;   // a lane pair's row
  const float* srow = my_s + row * L::LS;
  bf16* prow = my_p + row * L::LP;
  float m = p.mode == NOMAX ? NOMAX_SHIFT : NEG, l = 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[DP / 16];
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) wmma::fill_fragment(oacc[j], 0.f);

  auto load_k = [&](int k0) {
    if (KT)   // rows = depth, columns = keys
      load_tile<DP, BK, NTH>(ks, L::LK, kg + k0 * p.k_ss, p.k_sd, p.D,
                             p.S - k0, tid);
    else
      load_tile<BK, DP, NTH>(ks, L::LK, kg + k0 * p.k_ss, p.k_ss, p.S - k0,
                             p.D, tid);
  };
  // the warp's (16, BK) fp32 products q . k into my_s (unscaled)
  auto scores = [&]() {
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
      wmma::fill_fragment(sacc, 0.f);
#pragma unroll
      for (int ch = 0; ch < DP / 16; ++ch) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, qs + r0 * L::LQ + ch * 16, L::LQ);
        if constexpr (KT) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
          wmma::load_matrix_sync(bm, ks + ch * 16 * L::LK + j * 16, L::LK);
          wmma::mma_sync(sacc, a, bm, sacc);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
          wmma::load_matrix_sync(bm, ks + j * 16 * L::LK + ch * 16, L::LK);
          wmma::mma_sync(sacc, a, bm, sacc);
        }
      }
      wmma::store_matrix_sync(my_s + j * 16, sacc, L::LS, wmma::mem_row_major);
    }
    __syncwarp();
  };
  // s = fp32 product * scale, keys past S masked
  auto score = [&](int k0, int c) {
    return k0 + c < p.S ? __fmul_rn(srow[c], p.scale) : NEG;
  };

  if (p.mode == SINGLE) {   // sweep 1: each row's exact max over every key
    for (int k0 = 0; k0 < p.S; k0 += BK) {
      __syncthreads();
      load_k(k0);
      __syncthreads();
      scores();
      float mx = NEG;
      for (int c = half; c < BK; c += 2) mx = fmaxf(mx, score(k0, c));
      m = fmaxf(m, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1)));
      __syncwarp();
    }
  }

  for (int k0 = 0; k0 < p.S; k0 += BK) {
    __syncthreads();   // every warp is done with the previous K/V tile
    load_k(k0);
    load_tile<BK, DP, NTH>(vs, L::LV, vg + k0 * p.v_ss, p.v_ss, p.S - k0, p.D,
                           tid);
    __syncthreads();
    scores();

    float m_new = m;
    if (p.mode == ONLINE) {
      float mx = NEG;
      for (int c = half; c < BK; c += 2) mx = fmaxf(mx, score(k0, c));
      m_new = fmaxf(m, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1)));
    }
    float sum = 0.f;
    for (int c = half; c < BK; c += 2) {
      const float x = __fsub_rn(score(k0, c), m_new);
      bf16 e;
      if (p.bf16_probs) {
        e = __float2bfloat16(expf(__bfloat162float(__float2bfloat16(x))));
        sum += __bfloat162float(e);
      } else {
        const float ef = expf(x);
        sum += ef;
        e = __float2bfloat16(ef);
      }
      prow[c] = e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (p.mode == ONLINE) {
      const float alpha = expf(__fsub_rn(m, m_new));
      l = __fadd_rn(__fmul_rn(l, alpha), sum);
      m = m_new;
#pragma unroll
      for (int j = 0; j < DP / 16; ++j)
        wmma::store_matrix_sync(my_o + j * 16, oacc[j], L::LO, wmma::mem_row_major);
      __syncwarp();
      for (int c = half; c < DP; c += 2) my_o[row * L::LO + c] *= alpha;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < DP / 16; ++j)
        wmma::load_matrix_sync(oacc[j], my_o + j * 16, L::LO, wmma::mem_row_major);
    } else {
      l += sum;
    }
    __syncwarp();

    // O rows += P . V on the tensor cores
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, my_p + kk, L::LP);
        wmma::load_matrix_sync(bm, vs + kk * L::LV + j * 16, L::LV);
        wmma::mma_sync(oacc[j], a, bm, oacc[j]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int j = 0; j < DP / 16; ++j)
    wmma::store_matrix_sync(my_o + j * 16, oacc[j], L::LO, wmma::mem_row_major);
  __syncwarp();
  const int qr = q0 + r0 + row;
  if (qr < p.T) {
    bf16* og = p.o + (((long long)b * p.T + qr) * p.H + h) * p.D;
    const float den = fmaxf(l, 1e-30f);
    for (int c = half; c < p.D; c += 2)
      og[c] = __float2bfloat16(__fdiv_rn(my_o[row * L::LO + c], den));
  }
}

template <int BQ, int BK, bool KT>
cudaError_t launch(const Params& p, cudaStream_t st) {
  using L = Lay<BQ, BK, KT>;
  constexpr size_t smem = L::total;
  static_assert(smem <= 232448, "shared memory of one block");
  cudaError_t e = cudaFuncSetAttribute(flash_variant<BQ, BK, KT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.T + BQ - 1) / BQ, p.B * p.H);
  flash_variant<BQ, BK, KT><<<grid, L::NTH, smem, st>>>(p);
  return cudaGetLastError();
}

template <bool KT>
cudaError_t by_tile(int bq, int bk, const Params& p, cudaStream_t st) {
  if (bq == 64 && bk == 64) return launch<64, 64, KT>(p, st);
  if (bq == 128 && bk == 64) return launch<128, 64, KT>(p, st);
  if (bq == 128 && bk == 128) return launch<128, 128, KT>(p, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, v (B, T|S, H, D) bf16 with unit last strides; k bf16 with strides
// (k_sb, k_ss, k_sh, k_sd), k_sd = 1 (kt = 0) or k_ss = 1 (kt = 1); o a
// contiguous bf16 (B, T, H, D); D a multiple of 8, at most 48; q, k, v
// 16-byte aligned with strides of 8-element multiples, and S a multiple of
// 8 with kt. mode: 0 single-pass, 1 online, 2 no-max; tile (bq, bk) in
// {(64, 64), (128, 64), (128, 128)}. Returns a cudaError_t (0 = launched).
extern "C" int gill_flash_variant(const void* q, const void* k, const void* v,
                                  void* o, int B, int T, int S, int H, int D,
                                  int mode, int bf16_probs, int kt, int bq,
                                  int bk, long long q_sb, long long q_st,
                                  long long q_sh, long long k_sb,
                                  long long k_ss, long long k_sh,
                                  long long k_sd, long long v_sb,
                                  long long v_ss, long long v_sh, float scale,
                                  void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || D <= 0 || D > DP || D % 8 ||
      mode < 0 || mode > 2 || B * H > 65535 || (kt ? k_ss : k_sd) != 1 ||
      (kt && S % 8))
    return (int)cudaErrorInvalidValue;
  const long long kc = kt ? k_sd : k_ss;   // k's row stride in its tile
  for (long long stride : {q_sb, q_st, q_sh, k_sb, kc, k_sh, v_sb, v_ss, v_sh})
    if (stride % 8) return (int)cudaErrorInvalidValue;
  for (const void* ptr : {q, k, v})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return (int)cudaErrorInvalidValue;
  Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<bf16*>(o),
           B, T, S, H, D, mode, bf16_probs,
           q_sb, q_st, q_sh, k_sb, k_ss, k_sh, k_sd, v_sb, v_ss, v_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(kt ? by_tile<true>(bq, bk, p, st) : by_tile<false>(bq, bk, p, st));
}
