// Int8-QK flash attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces gill_tpu/ops/attention.py `flash_attention_bthd(q8=True)`
// (Pallas body `_flash_kernel_i8`), the SD UNet's attention under
// `unet.apply(q8=True)`:
//   k: one scale per (b, h), sk = max(amax|k| / 127, 1e-12), kq = clip(
//      round(k / sk), +-127) (round half to even, a true division);
//   q: one scale per (b, h, group of `qblock` consecutive query rows), the
//      same way (gill_tpu's group is its q block, 1024 at the UNet's shapes);
//   s = float(qq . kq^T as int32) * ((sq * sk) * scale);
//   exact softmax, p rounded to bf16 for the P.V product with fp32 sums,
//   out = bf16(acc / max(l, 1e-30)). Non-causal.
// q (B, T, H, D) and k/v (B, S, H, D) come with their own strides and a
// unit last stride; out is a contiguous (B, T, H, D); D <= 128.
//
// What bounds it on an H100: at the UNet's 64 x 64 self-attention (T = S =
// 4096, d = 40) the work is ~4 T S d operations against ~4 (T + S) d bytes,
// so it is compute-bound: QK on the int8 tensor cores (twice the bf16
// rate), PV on the bf16 ones, the softmax's exp and reductions on the CUDA
// cores. Two kernels, one launch each:
//  * `quantize_qk`, the pre-pass: one block per (b, h, query group) and per
//    (b, h) for the keys; the block's amax (a block reduction), then the
//    int8 rows, zero-padded from D to DP (a multiple of 16) into scratch
//    (B*H, T|S, DP) and the scales into scratch vectors;
//  * `flash_fwd_i8`: one block = 64 query rows of one (b, h), one warp per
//    16 rows; per 64-key tile, the scores on WMMA s8 16x16x16 with int32
//    sums, an online softmax (the same function as the row-max softmax in
//    one pass), and O += P.V on WMMA bf16 with fp32 sums, as csrc/
//    flash_attn.cu's bf16 kernel does. An int8 fragment's 16-byte depth
//    slice must start 32-byte aligned, so the int8 tiles sit in shared
//    memory as [depth chunk][row][32 bytes], 16 of them used.
// cp.async pipelining, mma.sync k32 fragments and wgmma are later work.

#include <mma.h>

#include <initializer_list>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr float NEG = -1e30f;    // gill_tpu's _NEG_INF
constexpr int QT = 256;          // pre-pass threads

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  signed char* qq;   // (B*H, T, DP)
  signed char* kq;   // (B*H, S, DP)
  float* sq;         // (B*H, ngroups)
  float* sk;         // (B*H)
  int B, T, S, H, D, DP, qblock, ngroups;
  int vec;           // 16-byte V loads: D, V's strides and base 8-aligned
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

__global__ void __launch_bounds__(QT) quantize_qk(Params p) {
  __shared__ float red[QT / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const bool is_k = blockIdx.y == p.ngroups;
  const bf16* src;
  long long rs;
  int nrows;
  signed char* dst;
  float* scale_out;
  if (is_k) {
    src = p.k + b * p.k_sb + h * p.k_sh;
    rs = p.k_ss;
    nrows = p.S;
    dst = p.kq + (long long)bh * p.S * p.DP;
    scale_out = p.sk + bh;
  } else {
    const int r0 = blockIdx.y * p.qblock;
    src = p.q + b * p.q_sb + h * p.q_sh + r0 * p.q_st;
    rs = p.q_st;
    nrows = min(p.qblock, p.T - r0);
    dst = p.qq + ((long long)bh * p.T + r0) * p.DP;
    scale_out = p.sq + (long long)bh * p.ngroups + blockIdx.y;
  }
  float mx = 0.f;
  for (int i = tid; i < nrows * p.D; i += QT) {
    const int r = i / p.D, c = i % p.D;
    mx = fmaxf(mx, fabsf(__bfloat162float(src[r * rs + c])));
  }
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (warp == 0) {
    float v = lane < QT / 32 ? red[lane] : 0.f;
    v = warp_max(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float s = fmaxf(__fdiv_rn(red[0], 127.f), 1e-12f);
  if (tid == 0) *scale_out = s;
  for (int i = tid; i < nrows * p.DP; i += QT) {
    const int r = i / p.DP, c = i % p.DP;
    float f = 0.f;
    if (c < p.D) f = rintf(__fdiv_rn(__bfloat162float(src[r * rs + c]), s));
    dst[(long long)r * p.DP + c] = (signed char)fminf(fmaxf(f, -127.f), 127.f);
  }
}

template <int DP> struct ICfg {
  static constexpr int BQ = 64, BK = 64, NWARP = 4;
  static constexpr int NCH = DP / 16;     // 16-byte depth chunks of a row
  static constexpr int LV = DP + 8;       // bf16 row stride of V
  static constexpr int LS = BK + 4;       // int32 / fp32 row stride of S
  static constexpr int LP = BK + 8;       // bf16 row stride of P
  static constexpr int LO = DP + 4;       // fp32 row stride of O
};

constexpr size_t a128(size_t n) { return (n + 127) / 128 * 128; }

template <int DP> struct ISmem {
  using C = ICfg<DP>;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + a128(32 * C::NCH * C::BQ);
  static constexpr size_t v = k + a128(32 * C::NCH * C::BK);
  static constexpr size_t s = v + a128(2 * C::BK * C::LV);
  static constexpr size_t pr = s + a128(4 * C::BQ * C::LS);
  static constexpr size_t o = pr + a128(2 * C::BQ * C::LP);
  static constexpr size_t stats = o + a128(4 * C::BQ * C::LO);
  static constexpr size_t total = stats + 2 * 4 * C::BQ;
};

// rows [row0, row0 + n) of an int8 (rows, DP) scratch matrix into the
// [chunk][rows][32] shared layout, zeros past n rows
template <int DP, int ROWS, int NTH>
__device__ __forceinline__ void load_i8(signed char* dst,
                                        const signed char* src, int row0,
                                        int n, int tid) {
  constexpr int NCH = DP / 16;
  for (int i = tid; i < ROWS * NCH; i += NTH) {
    const int r = i / NCH, ch = i % NCH;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < n)
      x = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * DP +
                                          ch * 16);
    *reinterpret_cast<uint4*>(dst + (ch * ROWS + r) * 32) = x;
  }
}

template <int DP>
__global__ void __launch_bounds__(ICfg<DP>::NWARP * 32)
    flash_fwd_i8(Params p) {
  using C = ICfg<DP>;
  using L = ISmem<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, NTH = C::NWARP * 32;
  extern __shared__ __align__(128) unsigned char smem_i8[];
  signed char* qs = reinterpret_cast<signed char*>(smem_i8 + L::q);
  signed char* ks = reinterpret_cast<signed char*>(smem_i8 + L::k);
  bf16* vs = reinterpret_cast<bf16*>(smem_i8 + L::v);     // [BK][LV]
  int* ss = reinterpret_cast<int*>(smem_i8 + L::s);       // [BQ][LS]
  bf16* ps = reinterpret_cast<bf16*>(smem_i8 + L::pr);    // [BQ][LP]
  float* os = reinterpret_cast<float*>(smem_i8 + L::o);   // [BQ][LO]
  float* m_s = reinterpret_cast<float*>(smem_i8 + L::stats);
  float* l_s = m_s + BQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;
  const int D = p.D;
  const bf16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const signed char* kqg = p.kq + (long long)bh * p.S * DP;

  load_i8<DP, BQ, NTH>(qs, p.qq + (long long)bh * p.T * DP, q0,
                       min(BQ, p.T - q0), tid);
  for (int i = tid; i < BQ * DP; i += NTH) os[(i / DP) * C::LO + i % DP] = 0.f;
  for (int r = tid; r < BQ; r += NTH) {
    m_s[r] = NEG;
    l_s[r] = 0.f;
  }

  const int r0 = warp * 16;           // this warp's 16 query rows
  int* my_s = ss + r0 * C::LS;
  bf16* my_p = ps + r0 * C::LP;
  float* my_o = os + r0 * C::LO;
  // each lane pair's row: its combined score scale (sq * sk) * scale
  const int my_row = lane >> 1, half = lane & 1;
  const int qr = q0 + r0 + my_row;
  const int grp = min(qr / p.qblock, p.ngroups - 1);
  const float cr = __fmul_rn(__fmul_rn(p.sq[(long long)bh * p.ngroups + grp],
                                       p.sk[bh]), p.scale);

  for (int k0 = 0; k0 < p.S; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    const int nk = min(BK, p.S - k0);
    load_i8<DP, BK, NTH>(ks, kqg, k0, nk, tid);
    if (p.vec) {
      for (int i = tid; i < BK * (DP / 8); i += NTH) {
        const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
        uint4 x = make_uint4(0, 0, 0, 0);
        if (r < nk && c < D)
          x = *reinterpret_cast<const uint4*>(vg + (k0 + r) * p.v_ss + c);
        *reinterpret_cast<uint4*>(vs + r * C::LV + c) = x;
      }
    } else {
      const bf16 zero = __float2bfloat16(0.f);
      for (int i = tid; i < BK * DP; i += NTH) {
        const int r = i / DP, c = i % DP;
        vs[r * C::LV + c] =
            (r < nk && c < D) ? vg[(k0 + r) * p.v_ss + c] : zero;
      }
    }
    __syncthreads();

    // scores: (16, BK) int32 = Q rows . K^T on the int8 tensor cores
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> sacc;
      wmma::fill_fragment(sacc, 0);
#pragma unroll
      for (int ch = 0; ch < C::NCH; ++ch) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::col_major> bm;
        wmma::load_matrix_sync(a, qs + (ch * BQ + r0) * 32, 32);
        wmma::load_matrix_sync(bm, ks + (ch * BK + j * 16) * 32, 32);
        wmma::mma_sync(sacc, a, bm, sacc);
      }
      wmma::store_matrix_sync(my_s + j * 16, sacc, C::LS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: lanes 2r and 2r+1 own row r of this warp's 16 rows,
    // the even and the odd score columns; the PV product sees p in bf16
    {
      const int r = my_row;
      const int* srow = my_s + r * C::LS;
      float x[BK / 2];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int c = 2 * j + half;
        x[j] = k0 + c < p.S ? __fmul_rn((float)srow[c], cr) : NEG;
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

    // O rows += P . V on the bf16 tensor cores
#pragma unroll 2
    for (int j = 0; j < DP / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, my_o + j * 16, C::LO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, my_p + kk, C::LP);
        wmma::load_matrix_sync(bm, vs + kk * C::LV + j * 16, C::LV);
        wmma::mma_sync(oacc, a, bm, oacc);
      }
      wmma::store_matrix_sync(my_o + j * 16, oacc, C::LO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  bf16* og = p.o + ((long long)b * p.T * p.H + h) * D;
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i % D, row = q0 + r0 + r;
    if (row >= p.T) continue;
    const float inv = 1.f / fmaxf(l_s[r0 + r], 1e-30f);
    og[(long long)row * p.H * D + c] = __float2bfloat16(my_o[r * C::LO + c] * inv);
  }
}

template <int DP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  quantize_qk<<<dim3(p.B * p.H, p.ngroups + 1), QT, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr size_t smem = ISmem<DP>::total;
  e = cudaFuncSetAttribute(flash_fwd_i8<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.T + ICfg<DP>::BQ - 1) / ICfg<DP>::BQ, p.B * p.H);
  flash_fwd_i8<DP><<<grid, ICfg<DP>::NWARP * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

int padded_dim(int D) {
  return D <= 0 ? -1 : D <= 48 ? 48 : D <= 80 ? 80 : D <= 128 ? 128 : -1;
}

}  // namespace

// The int8 head dim DP the scratch rows take for head dim D (48, 80 or
// 128), or -1 when the kernel does not take D.
extern "C" int gill_flash_attn_q8_dp(int D) { return padded_dim(D); }

// q, k, v bf16 with unit last strides and the strides given; o a contiguous
// bf16 (B, T, H, D); scratch qq (B*H, T, DP) and kq (B*H, S, DP) int8, sq
// (B*H, ceil(T / qblock)) and sk (B*H) fp32, DP = gill_flash_attn_q8_dp(D).
// Returns a cudaError_t (0 = launched).
extern "C" int gill_flash_attn_q8(const void* q, const void* k, const void* v,
                                  void* o, void* qq, void* kq, void* sq,
                                  void* sk, int B, int T, int S, int H, int D,
                                  int qblock, long long q_sb, long long q_st,
                                  long long q_sh, long long k_sb,
                                  long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss,
                                  long long v_sh, float scale, void* stream) {
  const int DP = padded_dim(D);
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || DP < 0 || qblock <= 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  bool vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  for (long long stride : {v_sb, v_ss, v_sh}) vec = vec && stride % 8 == 0;
  Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<bf16*>(o),
           static_cast<signed char*>(qq), static_cast<signed char*>(kq),
           static_cast<float*>(sq), static_cast<float*>(sk),
           B, T, S, H, D, DP, qblock, (T + qblock - 1) / qblock, (int)vec,
           q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (DP) {
    case 48: return (int)launch<48>(p, st);
    case 80: return (int)launch<80>(p, st);
    case 128: return (int)launch<128>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
