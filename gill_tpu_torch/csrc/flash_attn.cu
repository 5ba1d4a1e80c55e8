// Flash attention forward for Hopper (sm_90a) in exact fp32: K1's fp32
// calls (CLIP ViT-L/14 at head dim 64, the OPT prefill at 128, causal).
// bf16 calls take csrc/flash_mma.cu (K2 at head dims <= 80, K1 above);
// this library refuses them.
//
// Replaces gill_tpu/ops/attention.py `flash_attention` (Pallas body
// `_flash_kernel`, K1) for fp32 operands: out = softmax(scale * q k^T) v
// with an online softmax whose statistics stay in fp32, causal masking
// aligned bottom-right (key j visible to query i when j <= i + S - T), and
// keys at or beyond `kv_len` masked. The Pallas `fast` clamp-shift softmax
// is computed exactly here.
//
// Layout: q (B, T, H, D), k/v (B, S, H, D), each with its own batch, row
// and head strides and a unit last stride; D a multiple of 4, every base
// 16-byte aligned and every stride a multiple of 4 elements (the wrapper
// pads or copies otherwise); out a contiguous (B, T, H, D). The head dim is
// zero-filled in shared memory up to DP in {64, 96, 128, 160, 256, 512}.
//
// What bounds it on an H100: the products stay on the CUDA cores in fp32
// FMA (TF32 breaks greedy-token parity), so the FMA rate bounds it:
// 4 T S D flops at 67 TFLOP/s, 0.004 ms for CLIP and 0.013 ms for the
// causal prefill, while its bytes take a third of that. What the design
// does about it:
//  * one block = BQ = 4 * RW query rows of one (b, h), four warps, each
//    warp owning RW rows for the whole key loop: its scores, running max
//    and sum and its (RW, DP) output stay in registers. A lane (row group
//    rg = lane / 8, key group kg = lane % 8) holds RM = RW / 4 rows: scores
//    of keys kg + 8 n, output columns 4 (kg + 8 c) .. + 3. The row max and
//    sum are shuffles among the 8 lanes of a row group;
//  * S = Q K^T reads float4 of Q (broadcast in the row group) and of K
//    (8 rows a phase, row stride DP + 4 floats: conflict-free) into an
//    RM x RN register micro-tile, 4 RM RN FMAs for RM + RN shared loads
//    (32 for 6 at RW 8, BK 32); P.V takes each probability from its lane
//    by a shuffle and V as float4 of 8 consecutive lanes, 4 RM CV FMAs for
//    CV + RM loads and shuffles;
//  * `scale * log2(e)` is one factor applied with the row max, exp2 takes
//    the shifted score (masked keys -1e30, as gill_tpu's _NEG_INF);
//  * K/V tiles stream through a two-stage ring filled by 16-byte cp.async
//    with one block barrier a key tile (tile j + 1 lands while tile j is
//    computed); ragged rows and the head dim past D are zero-filled by the
//    copies' source size;
//  * BQ 32 puts CLIP on 16 x 9 = 144 blocks and the prefill on 320; causal
//    blocks walk keys only to their diagonal and the longest start first.
// DP 512 takes RW 4 and BK 16 to keep its output in 64 registers a lane
// and its ring in shared memory; no path of the model calls it.

#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int NT = 128;                 // four warps
constexpr float NEG = -1e30f;           // gill_tpu's _NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

template <int DP> struct Cfg {
  static constexpr int RW = DP >= 512 ? 4 : 8;    // rows a warp
  static constexpr int BK = DP >= 512 ? 16 : 32;  // keys a tile
  static constexpr int BQ = 4 * RW;
  static constexpr int RM = RW / 4;               // rows a lane
  static constexpr int RN = BK / 8;               // keys a lane
  static constexpr int CV = DP / 32;              // float4 columns a lane
  static constexpr int LD = DP + 4;               // shared row stride
  static constexpr int NC = DP / 4;               // 16-byte chunks a row
  static constexpr size_t SMEM = sizeof(float) * (size_t)LD * (BQ + 4 * BK);
  static_assert(DP % 32 == 0 && RW % 4 == 0 && BK % 8 == 0, "tile");
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int B, T, S, H, D, kv_len, causal;
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

// rows [0, n) of a strided fp32 matrix into a [ROWS][LD] shared tile;
// rows past n and chunks past nc are zero-filled
template <int ROWS, int NC, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long rs, int n, int nc,
                                          int tid) {
#pragma unroll 4
  for (int i = tid; i < ROWS * NC; i += NT) {
    const int r = i / NC, c = i - (i / NC) * NC;
    const bool ok = r < n && c < nc;
    cp_async16_zf(dst + r * LD + 4 * c, ok ? src + r * rs + 4 * c : src, ok);
  }
}

__device__ __forceinline__ float fma4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int DP>
__global__ void __launch_bounds__(NT) flash_f32(const Params p) {
  using C = Cfg<DP>;
  constexpr int RW = C::RW, BQ = C::BQ, BK = C::BK, RM = C::RM, RN = C::RN;
  constexpr int CV = C::CV;
  constexpr int LD = C::LD, NC = C::NC;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [BQ][LD]
  float* ks = qs + BQ * LD;         // [2][BK][LD]
  float* vs = ks + 2 * BK * LD;     // [2][BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane >> 3, kg = lane & 7;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  // causal: the blocks with the most keys first
  const int qb = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qb * BQ;
  const int nc = p.D / 4;
  const float* qg = p.q + b * p.q_sb + h * p.q_sh;
  const float* kg_ = p.k + b * p.k_sb + h * p.k_sh;
  const float* vg = p.v + b * p.v_sb + h * p.v_sh;

  const int off = p.S - p.T;
  int kend = min(p.kv_len, p.S);
  if (p.causal) kend = min(kend, min(q0 + BQ, p.T) + off);
  const int nkt = kend > 0 ? (kend + BK - 1) / BK : 0;

  load_rows<BQ, NC, LD>(qs, qg + (long long)q0 * p.q_st, p.q_st,
                        min(BQ, p.T - q0), nc, tid);
  if (nkt > 0) {
    const int nk = min(BK, p.S);
    load_rows<BK, NC, LD>(ks, kg_, p.k_ss, nk, nc, tid);
    load_rows<BK, NC, LD>(vs, vg, p.v_ss, nk, nc, tid);
  }
  cp_async_commit();

  const int row0 = warp * RW + rg * RM;    // this lane's first row
  const float c = p.scale * LOG2E;
  float o[RM][CV][4];
  float m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CV; ++j) o[i][j][0] = o[i][j][1] = o[i][j][2] =
        o[i][j][3] = 0.f;
  }

  for (int j = 0; j < nkt; ++j) {
    cp_async_wait_prior<0>();   // tile j (and Q) have landed
    __syncthreads();            // for every warp; tile j - 1 is read
    if (j + 1 < nkt) {
      const int k1 = (j + 1) * BK, nk = min(BK, p.S - k1);
      const int st = (j + 1) & 1;
      load_rows<BK, NC, LD>(ks + st * BK * LD, kg_ + (long long)k1 * p.k_ss,
                            p.k_ss, nk, nc, tid);
      load_rows<BK, NC, LD>(vs + st * BK * LD, vg + (long long)k1 * p.v_ss,
                            p.v_ss, nk, nc, tid);
    }
    cp_async_commit();
    const float* kt = ks + (j & 1) * BK * LD;
    const float* vt = vs + (j & 1) * BK * LD;
    const int k0 = j * BK;

    // S = Q K^T, an RM x RN micro-tile a lane
    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int n = 0; n < RN; ++n) s[i][n] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < NC; ++d4) {
      float4 qv[RM], kv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (row0 + i) * LD + 4 * d4);
#pragma unroll
      for (int n = 0; n < RN; ++n)
        kv[n] = *reinterpret_cast<const float4*>(kt + (kg + 8 * n) * LD +
                                                 4 * d4);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int n = 0; n < RN; ++n) s[i][n] = fma4(qv[i], kv[n], s[i][n]);
    }

    // masks only where the tile crosses the key edge or the diagonal
    const bool edge = k0 + BK > p.kv_len ||
                      (p.causal && k0 + BK - 1 > q0 + warp * RW + off);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qr = q0 + row0 + i;
#pragma unroll
      for (int n = 0; n < RN; ++n) {
        const int kp = k0 + kg + 8 * n;
        s[i][n] = (edge && (kp >= p.kv_len || (p.causal && kp > qr + off)))
                      ? NEG : s[i][n] * c;
      }
    }

    // online softmax over the 8 lanes of the row group
    float pr[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int n = 1; n < RN; ++n) mx = fmaxf(mx, s[i][n]);
#pragma unroll
      for (int sh = 1; sh < 8; sh <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float mn = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < RN; ++n) {
        pr[i][n] = exp2f(s[i][n] - mn);
        sum += pr[i][n];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j2 = 0; j2 < CV; ++j2) {
        o[i][j2][0] *= alpha;
        o[i][j2][1] *= alpha;
        o[i][j2][2] *= alpha;
        o[i][j2][3] *= alpha;
      }
    }

    // O += P V: key kk's probability from lane (rg, kk % 8)
    const int src0 = lane & ~7;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pv[i] = __shfl_sync(0xffffffffu, pr[i][kk >> 3], src0 + (kk & 7));
      const float* vrow = vt + kk * LD;
#pragma unroll
      for (int j2 = 0; j2 < CV; ++j2) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vrow + 4 * (kg + 8 * j2));
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          o[i][j2][0] = fmaf(pv[i], vv.x, o[i][j2][0]);
          o[i][j2][1] = fmaf(pv[i], vv.y, o[i][j2][1]);
          o[i][j2][2] = fmaf(pv[i], vv.z, o[i][j2][2]);
          o[i][j2][3] = fmaf(pv[i], vv.w, o[i][j2][3]);
        }
      }
    }
  }

  // epilogue: the row group's sums, O / max(l, 1e-30), float4 stores
  float* og = p.o + ((long long)b * p.T * p.H + h) * p.D;
  const long long orow = (long long)p.H * p.D;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float li = l[i];
#pragma unroll
    for (int sh = 1; sh < 8; sh <<= 1)
      li += __shfl_xor_sync(0xffffffffu, li, sh);
    const float inv = 1.f / fmaxf(li, 1e-30f);
    const int qr = q0 + row0 + i;
    if (qr >= p.T) continue;
#pragma unroll
    for (int j2 = 0; j2 < CV; ++j2) {
      const int col = 4 * (kg + 8 * j2);
      if (col < p.D)
        *reinterpret_cast<float4*>(og + qr * orow + col) =
            make_float4(o[i][j2][0] * inv, o[i][j2][1] * inv,
                        o[i][j2][2] * inv, o[i][j2][3] * inv);
    }
  }
}

template <int DP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<DP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.T + C::BQ - 1) / C::BQ, p.B * p.H);
  flash_f32<DP><<<grid, NT, C::SMEM, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr, std::initializer_list<long long> strides) {
  bool ok = reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (long long s : strides) ok = ok && s % 4 == 0;
  return ok;
}

}  // namespace

// fp32 attention (K1). q, k, v fp32 with unit last strides, the strides
// given in elements (multiples of 4) and 16-byte aligned bases; o a
// contiguous fp32 (B, T, H, D); D a multiple of 4 up to 512; dp the
// kernel's head dim, which fixes its tile (`ops/attention.py`
// `flash_plan`). Returns a cudaError_t (0 = launched).
extern "C" int gill_flash_attn(const void* q, const void* k, const void* v,
                               void* o, int B, int T, int S, int H, int D,
                               long long q_sb, long long q_st, long long q_sh,
                               long long k_sb, long long k_ss, long long k_sh,
                               long long v_sb, long long v_ss, long long v_sh,
                               float scale, int causal, int kv_len, int dp,
                               void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || D <= 0 || D % 4 || D > dp ||
      B * H > 65535 || kv_len <= 0 || kv_len > S)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q, {q_sb, q_st, q_sh}) || !aligned16(k, {k_sb, k_ss, k_sh}) ||
      !aligned16(v, {v_sb, v_ss, v_sh}) || !aligned16(o, {}))
    return (int)cudaErrorMisalignedAddress;
  const Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<float*>(o),
                 B, T, S, H, D, kv_len, causal,
                 q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 64: return (int)launch<64>(p, st);
    case 96: return (int)launch<96>(p, st);
    case 128: return (int)launch<128>(p, st);
    case 160: return (int)launch<160>(p, st);
    case 256: return (int)launch<256>(p, st);
    case 512: return (int)launch<512>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}
