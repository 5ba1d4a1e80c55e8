// Flash attention forward for Hopper (sm_90a), fp32 at every head dim and
// bf16 at head dims above 80.
//
// Replaces gill_tpu/ops/attention.py `flash_attention` (Pallas body
// `_flash_kernel`, K1): out = softmax(scale * q k^T) v with an online
// softmax whose statistics stay in fp32, causal masking aligned
// bottom-right (key j visible to query i when j <= i + S - T), and keys at
// or beyond `kv_len` masked. The Pallas `fast` clamp-shift softmax is
// computed exactly here. bf16 calls at head dims <= 80 (the UNet's K2 and
// its int8-QK twin K10) take csrc/flash_mma.cu instead; this library
// refuses them.
//
// Layout: q (B, T, H, D), k/v (B, S, H, D), each with its own batch, row
// and head strides and a unit last stride, read at the TRUE head dim (no
// 128-lane padding, no transposes); out is a contiguous (B, T, H, D). The
// head dim is zero-filled in shared memory up to DP, a multiple of 16 from
// {48, 64, 80, 128, 160, 256, 512} (48-80 fp32 only), so every shape of
// the path compiles to a fixed tile.
//
// What bounds it on an H100: at the main path's shapes (VAE D = 512, UNet
// D = 160, CLIP and the OPT prefill) the work is O(T*S*D) FLOPs against
// O((T+S)*D) bytes, so it is compute-bound: the products belong on the
// tensor cores, and the online softmax (exp and two warp reductions per row
// and key tile) on the CUDA cores is what remains. Two kernels:
//  * bf16 (UNet D 160, VAE): `flash_fwd_tc`, both products on the tensor
//    cores (WMMA 16x16x16, fp32 accumulation), the probabilities rounded to
//    bf16 before the PV product as the Pallas kernel feeds its MXU;
//  * fp32 (CLIP and the OPT prefill, where TF32 would break greedy-token
//    parity): `flash_fwd`, fp32 FMA on the CUDA cores, exact. One block =
//    BQ query rows of one (b, h), 4 warps; the (BQ, DP) fp32 output
//    accumulator lives in registers (BQ * DP <= 8192, at most 64 floats a
//    thread): BQ shrinks to 32 at DP 160/256 and to 16 at DP 512, which is
//    also what keeps Q + K + V + scores under the 227 KB of shared memory.
// In both, key tiles above the causal diagonal of the block are never
// loaded. TMA/cp.async pipelining and wgmma are later work (csrc/
// flash_mma.cu has the register-resident mma.sync design for D <= 80).

#include <mma.h>

#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int NT = 128;
constexpr float NEG = -1e30f;   // gill_tpu's _NEG_INF

template <int DP> struct Cfg;
template <> struct Cfg<48> { static constexpr int BQ = 64, BK = 64; };
template <> struct Cfg<64> { static constexpr int BQ = 64, BK = 64; };
template <> struct Cfg<80> { static constexpr int BQ = 64, BK = 64; };
template <> struct Cfg<128> { static constexpr int BQ = 64, BK = 64; };
template <> struct Cfg<160> { static constexpr int BQ = 32, BK = 64; };
template <> struct Cfg<256> { static constexpr int BQ = 32, BK = 64; };
template <> struct Cfg<512> { static constexpr int BQ = 16, BK = 32; };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, T, S, H, D, kv_len, causal;
  int vec;  // 16-byte loads: D, every stride and base 8-element aligned
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

template <int DP> constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(Cfg<DP>::BQ + 2 * Cfg<DP>::BK) * (DP + 1) +
          (size_t)Cfg<DP>::BQ * (Cfg<DP>::BK + 1) + 3 * (size_t)Cfg<DP>::BQ);
}

template <int DP>
__global__ void __launch_bounds__(NT) flash_fwd(Params p) {
  constexpr int BQ = Cfg<DP>::BQ, BK = Cfg<DP>::BK, LD = DP + 1, LS = BK + 1;
  constexpr int RM = BQ / 8;    // rows per thread (8 row groups)
  constexpr int RN = BK / 16;   // score columns per thread (16 col groups)
  constexpr int RD = DP / 16;   // output columns per thread
  constexpr int KPL = BK / 32;  // score columns per lane in the softmax
  static_assert(BQ % 8 == 0 && BK % 32 == 0 && DP % 16 == 0, "tile");

  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][LD]
  float* ks = qs + BQ * LD;      // [BK][LD]
  float* vs = ks + BK * LD;      // [BK][LD]
  float* ss = vs + BK * LD;      // [BQ][LS] scores, then probabilities
  float* m_s = ss + BQ * LS;     // [BQ] running max
  float* l_s = m_s + BQ;         // [BQ] running denominator
  float* a_s = l_s + BQ;         // [BQ] rescale factor of this tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;
  const int D = p.D;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int i = tid; i < BQ * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (q0 + r < p.T && c < D) x = qg[(long long)(q0 + r) * p.q_st + c];
    qs[r * LD + c] = x;
  }
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = NEG;
    l_s[r] = 0.f;
  }

  float acc[RM][RD];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;

  const int off = p.S - p.T;
  int kend = min(p.kv_len, p.S);
  if (p.causal) kend = min(kend, min(q0 + BQ, p.T) - 1 + off + 1);

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers of ks/vs/ss are done
    for (int i = tid; i < BK * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < p.S && c < D) {
        kx = kg[(long long)(k0 + r) * p.k_ss + c];
        vx = vg[(long long)(k0 + r) * p.v_ss + c];
      }
      ks[r * LD + c] = kx;
      vs[r * LD + c] = vx;
    }
    __syncthreads();

    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[RM], kv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = qs[(ty * RM + i) * LD + d];
#pragma unroll
      for (int j = 0; j < RN; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty * RM + i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int c = tx + 16 * j, kp = k0 + c;
        const bool ok = kp < p.kv_len && (!p.causal || kp <= q0 + r + off);
        ss[r * LS + c] = ok ? s[i][j] * p.scale : NEG;
      }
    }
    __syncthreads();

    for (int r = warp; r < BQ; r += NT / 32) {
      float x[KPL];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        x[j] = ss[r * LS + lane + 32 * j];
        mx = fmaxf(mx, x[j]);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const float e = expf(x[j] - m_new);
        sum += e;
        ss[r * LS + lane + 32 * j] = e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float alpha = a_s[ty * RM + i];
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RM], vv[RD];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = ss[(ty * RM + i) * LS + kk];
#pragma unroll
      for (int j = 0; j < RD; ++j) vv[j] = vs[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  float* og = static_cast<float*>(p.o) + ((long long)b * p.T * p.H + h) * D;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    if (q0 + r >= p.T) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int c = tx + 16 * j;
      if (c < D) og[(long long)(q0 + r) * p.H * D + c] = acc[i][j] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 path, DP 128-512: both products on the tensor cores (WMMA 16x16x16,
// fp32 accumulation). One block = BQ query rows of one (b, h), one warp per 16
// rows; each warp owns its rows' scores, probabilities and output, so the
// only block-wide barriers are around the shared K/V tile loads. The
// (BQ, DP) fp32 output lives in shared memory: a warp rescales its rows by
// the online-softmax factor there and reloads them as the accumulator of
// the P.V product. DP 512 (the VAE) takes 32-row query and key tiles to
// fit shared memory.
// ---------------------------------------------------------------------------

template <int DP> struct TcCfg {
  static constexpr int BQ = DP >= 512 ? 32 : 64;
  static constexpr int BK = DP >= 512 ? 32 : 64;
  static constexpr int NWARP = BQ / 16;
  static constexpr int LQ = DP + 8;       // bf16 row stride of Q, K, V
  static constexpr int LS = BK + 4;       // fp32 row stride of the scores
  static constexpr int LP = BK + 8;       // bf16 row stride of P
  static constexpr int LO = DP + 4;       // fp32 row stride of O
};

constexpr size_t a128(size_t n) { return (n + 127) / 128 * 128; }

template <int DP> struct TcSmem {
  using C = TcCfg<DP>;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + a128(2 * C::BQ * C::LQ);
  static constexpr size_t v = k + a128(2 * C::BK * C::LQ);
  static constexpr size_t s = v + a128(2 * C::BK * C::LQ);
  static constexpr size_t pr = s + a128(4 * C::BQ * C::LS);
  static constexpr size_t o = pr + a128(2 * C::BQ * C::LP);
  static constexpr size_t stats = o + a128(4 * C::BQ * C::LO);
  static constexpr size_t total = stats + 3 * 4 * C::BQ;
};

// rows [row0, row0 + n) of a strided bf16 matrix into a [rows][ld] shared
// tile, zero-filled past n rows and past D columns up to DP
template <int DP, int NTH>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          long long stride, int row0, int n,
                                          int rows, int D, int vec, int tid) {
  if (vec) {
    constexpr int CH = DP / 8;
    for (int i = tid; i < rows * CH; i += NTH) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r < n && c < D)
        x = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < rows * DP; i += NTH) {
      const int r = i / DP, c = i % DP;
      dst[r * ld + c] = (r < n && c < D) ? src[(row0 + r) * stride + c] : zero;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(TcCfg<DP>::NWARP * 32)
    flash_fwd_tc(Params p) {
  using C = TcCfg<DP>;
  using L = TcSmem<DP>;
  using namespace nvcuda;
  constexpr int BQ = C::BQ, BK = C::BK, NTH = C::NWARP * 32;
  static_assert(DP % 16 == 0 && BK % 32 == 0, "tile");
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc + L::q);    // [BQ][LQ]
  bf16* ks = reinterpret_cast<bf16*>(smem_tc + L::k);    // [BK][LQ]
  bf16* vs = reinterpret_cast<bf16*>(smem_tc + L::v);    // [BK][LQ]
  float* ss = reinterpret_cast<float*>(smem_tc + L::s);  // [BQ][LS]
  bf16* ps = reinterpret_cast<bf16*>(smem_tc + L::pr);   // [BQ][LP]
  float* os = reinterpret_cast<float*>(smem_tc + L::o);  // [BQ][LO]
  float* m_s = reinterpret_cast<float*>(smem_tc + L::stats);
  float* l_s = m_s + BQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;
  const int D = p.D;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_rows<DP, NTH>(qs, C::LQ, qg, p.q_st, q0, min(BQ, p.T - q0), BQ, D,
                     p.vec, tid);
  for (int i = tid; i < BQ * DP; i += NTH) os[(i / DP) * C::LO + i % DP] = 0.f;
  for (int r = tid; r < BQ; r += NTH) {
    m_s[r] = NEG;
    l_s[r] = 0.f;
  }

  const int off = p.S - p.T;
  int kend = min(p.kv_len, p.S);
  if (p.causal) kend = min(kend, min(q0 + BQ, p.T) - 1 + off + 1);

  const int r0 = warp * 16;           // this warp's 16 query rows
  float* my_s = ss + r0 * C::LS;
  bf16* my_p = ps + r0 * C::LP;
  float* my_o = os + r0 * C::LO;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    const int nk = min(BK, p.S - k0);
    load_rows<DP, NTH>(ks, C::LQ, kg, p.k_ss, k0, nk, BK, D, p.vec, tid);
    load_rows<DP, NTH>(vs, C::LQ, vg, p.v_ss, k0, nk, BK, D, p.vec, tid);
    __syncthreads();

    // scores: (16, BK) = Q rows . K^T
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
      wmma::fill_fragment(sacc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
        wmma::load_matrix_sync(a, qs + r0 * C::LQ + kk, C::LQ);
        wmma::load_matrix_sync(bm, ks + j * 16 * C::LQ + kk, C::LQ);
        wmma::mma_sync(sacc, a, bm, sacc);
      }
      wmma::store_matrix_sync(my_s + j * 16, sacc, C::LS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: lanes 2r and 2r+1 own row r of this warp's 16 rows,
    // the even and the odd score columns; the PV product sees p in bf16
    {
      const int r = lane >> 1, half = lane & 1, qr = q0 + r0 + r;
      const float* srow = my_s + r * C::LS;
      float x[BK / 2];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int c = 2 * j + half, kp = k0 + c;
        const bool ok = kp < p.kv_len && (!p.causal || kp <= qr + off);
        x[j] = ok ? srow[c] * p.scale : NEG;
        mx = fmaxf(mx, x[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = m_s[r0 + r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      bf16* prow = my_p + r * C::LP;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const float e = expf(x[j] - m_new);
        sum += e;
        prow[2 * j + half] = __float2bfloat16(e);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = expf(m_old - m_new);
      float* orow = my_o + r * C::LO;
      for (int c = half; c < DP; c += 2) orow[c] *= alpha;
      __syncwarp();  // both lanes of the pair have read m_old
      if (half == 0) {
        l_s[r0 + r] = l_s[r0 + r] * alpha + sum;
        m_s[r0 + r] = m_new;
      }
    }
    __syncwarp();

    // O rows += P . V
#pragma unroll 2
    for (int j = 0; j < DP / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, my_o + j * 16, C::LO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, my_p + kk, C::LP);
        wmma::load_matrix_sync(bm, vs + kk * C::LQ + j * 16, C::LQ);
        wmma::mma_sync(oacc, a, bm, oacc);
      }
      wmma::store_matrix_sync(my_o + j * 16, oacc, C::LO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  bf16* og = static_cast<bf16*>(p.o) + ((long long)b * p.T * p.H + h) * D;
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i % D, qr = q0 + r0 + r;
    if (qr >= p.T) continue;
    const float inv = 1.f / fmaxf(l_s[r0 + r], 1e-30f);
    og[(long long)qr * p.H * D + c] = __float2bfloat16(my_o[r * C::LO + c] * inv);
  }
}

template <int DP>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.T + Cfg<DP>::BQ - 1) / Cfg<DP>::BQ, p.B * p.H);
  flash_fwd<DP><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = TcSmem<DP>::total;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.T + TcCfg<DP>::BQ - 1) / TcCfg<DP>::BQ, p.B * p.H);
  flash_fwd_tc<DP><<<grid, TcCfg<DP>::NWARP * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const Params& p, cudaStream_t stream) {
  if (p.D <= 48) return launch_f32<48>(p, stream);
  if (p.D <= 64) return launch_f32<64>(p, stream);
  if (p.D <= 80) return launch_f32<80>(p, stream);
  if (p.D <= 128) return launch_f32<128>(p, stream);
  if (p.D <= 160) return launch_f32<160>(p, stream);
  if (p.D <= 256) return launch_f32<256>(p, stream);
  if (p.D <= 512) return launch_f32<512>(p, stream);
  return cudaErrorInvalidValue;
}

// bf16 at D <= 80 is csrc/flash_mma.cu's
cudaError_t dispatch_bf16(const Params& p, cudaStream_t stream) {
  if (p.D <= 80) return cudaErrorInvalidValue;
  if (p.D <= 128) return launch_bf16<128>(p, stream);
  if (p.D <= 160) return launch_bf16<160>(p, stream);
  if (p.D <= 256) return launch_bf16<256>(p, stream);
  if (p.D <= 512) return launch_bf16<512>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (D <= 512), 1 = bfloat16 (80 < D <= 512). Returns a
// cudaError_t (0 = launched).
extern "C" int gill_flash_attn(int dtype, const void* q, const void* k,
                               const void* v, void* o, int B, int T, int S,
                               int H, int D, long long q_sb, long long q_st,
                               long long q_sh, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss,
                               long long v_sh, float scale, int causal,
                               int kv_len, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || D <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  bool vec = D % 8 == 0;
  for (long long stride : {q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh})
    vec = vec && stride % 8 == 0;
  for (const void* ptr : {q, k, v})
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  Params p{q, k, v, o, B, T, S, H, D, kv_len, causal, (int)vec,
           q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0 ? dispatch_f32(p, st)
                  : dtype == 1 ? dispatch_bf16(p, st)
                               : cudaErrorInvalidValue;
  return (int)e;
}
