// Valid-prefix single-token decode attention for Hopper (sm_90a).
//
// Replaces gill_tpu/ops/decode_attn.py `prefix_decode_attention` (Pallas
// `_kernel`): for each batch row b and head h,
//   out = softmax over [q . k_s * scale for s < len_b] + [q . k1 * scale]
//         applied to [v_s for s < len_b] + [v1],
// an exact softmax in fp32 over the first len_b rows of a bf16 (B, S, H, D)
// cache plus the token's own (k1, v1), which never enters the cache here;
// len_b = 0 gives v1. q may be bf16 or fp32; the output is in q's dtype.
//
// What bounds it on an H100: the valid cache rows. A step reads
// sum_b len_b * H * D * 2 (k and v) * 2 bytes a layer (16 slots of ~180
// rows at H = 32, D = 128: ~47 MB, ~14 us at 3.35 TB/s) and does ~4 FLOPs a
// byte; the plain path reads, and widens to fp32, the whole window. Design:
//  * one block of 4 warps per (b, h): B * H = 512 blocks at the serving
//    shapes; only ceil(len_b / 8) row groups are read (rows past len_b are
//    never loaded, so a parked slot reads nothing);
//  * each half-warp owns every 8th row; a row of D bf16 is 16 lanes x
//    16-byte loads (D = 128 * DC), and each lane issues the k and v loads
//    of U = 4 rows before it uses any, so ~32 KB an SM are in flight;
//  * q . k is reduced across the 16 lanes with shuffles; each half-warp
//    keeps its own running max, sum and fp32 accumulator (exact online
//    softmax), and the eight half-warp states merge through shared memory
//    in a fixed order, so results are deterministic;
//  * the own token folds in after the merge, as the Pallas kernel does;
//  * the cache is a strided view (a layer and a read window of the
//    (L, B, S, H, D) pool): the kernel takes its strides, no copy is made.
// Splitting long prefixes across blocks (flash-decoding) is later work.

#include "common.cuh"

namespace {

constexpr int NT = 128;          // 4 warps = 8 half-warps
constexpr int NHW = NT / 16;
constexpr int U = 4;             // rows a half-warp loads before using them
constexpr float NEG = -1e30f;    // gill_tpu's _NEG_INF

struct Params {
  const void* q;                 // (B, H, D), bf16 or fp32
  const bf16* k1;                // (B, H, D)
  const bf16* v1;
  const bf16* kc;                // cache views, element strides below
  const bf16* vc;
  const int* lengths;            // (B,)
  void* out;                     // (B, H, D), q's dtype
  long long ksb, kss, ksh, vsb, vss, vsh;
  int B, S, H, q_f32;
  float scale;
};

__device__ __forceinline__ void widen8(const uint4& u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(p[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

// sum over the 16 lanes of a half-warp (xor offsets below 16 stay inside it)
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DC>
__global__ void __launch_bounds__(NT) prefix_decode(Params p) {
  constexpr int D = 128 * DC;
  __shared__ float sm_m[NHW], sm_l[NHW], sm_l1;
  __shared__ float sm_acc[NHW][D];

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int tid = threadIdx.x, hw = tid / 16, li = tid % 16;
  int n = p.lengths[b];
  n = n < 0 ? 0 : (n > p.S ? p.S : n);
  const long long row = ((long long)b * p.H + h) * D;

  float qf[DC][8];
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    const int e = c * 128 + li * 8;
    if (p.q_f32) {
      const float4* qp = reinterpret_cast<const float4*>(
          static_cast<const float*>(p.q) + row + e);
      const float4 a = qp[0], bq = qp[1];
      qf[c][0] = a.x; qf[c][1] = a.y; qf[c][2] = a.z; qf[c][3] = a.w;
      qf[c][4] = bq.x; qf[c][5] = bq.y; qf[c][6] = bq.z; qf[c][7] = bq.w;
    } else {
      widen8(*reinterpret_cast<const uint4*>(
                 static_cast<const bf16*>(p.q) + row + e), qf[c]);
    }
  }

  const bf16* kb = p.kc + b * p.ksb + h * p.ksh + li * 8;
  const bf16* vb = p.vc + b * p.vsb + h * p.vsh + li * 8;
  float m = NEG, l = 0.f, acc[DC][8];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[c][j] = 0.f;

  for (int base = 0; base < n; base += NHW * U) {
    uint4 kr[U][DC], vr[U][DC];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * NHW + hw;
      ok[u] = r < n;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        kr[u][c] = ok[u] ? *reinterpret_cast<const uint4*>(kb + r * p.kss + c * 128)
                         : make_uint4(0, 0, 0, 0);
        vr[u][c] = ok[u] ? *reinterpret_cast<const uint4*>(vb + r * p.vss + c * 128)
                         : make_uint4(0, 0, 0, 0);
      }
    }
    float lg[U], mx = NEG;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        float kf[8];
        widen8(kr[u][c], kf);
#pragma unroll
        for (int j = 0; j < 8; ++j) s = fmaf(qf[c][j], kf[j], s);
      }
      s = half_sum(s) * p.scale;
      lg[u] = ok[u] ? s : NEG;
      mx = fmaxf(mx, lg[u]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[c][j] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float pu = ok[u] ? expf(lg[u] - m_new) : 0.f;
      l += pu;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        float vf[8];
        widen8(vr[u][c], vf);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[c][j] = fmaf(pu, vf[j], acc[c][j]);
      }
    }
    m = m_new;
  }

  // the own token's logit (every half-warp computes the same value)
  {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      float kf[8];
      widen8(*reinterpret_cast<const uint4*>(p.k1 + row + c * 128 + li * 8), kf);
#pragma unroll
      for (int j = 0; j < 8; ++j) s = fmaf(qf[c][j], kf[j], s);
    }
    s = half_sum(s) * p.scale;
    if (tid == 0) sm_l1 = s;
  }
  if (li == 0) {
    sm_m[hw] = m;
    sm_l[hw] = l;
  }
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) sm_acc[hw][c * 128 + li * 8 + j] = acc[c][j];
  __syncthreads();

  float mt = NEG;
#pragma unroll
  for (int i = 0; i < NHW; ++i) mt = fmaxf(mt, sm_m[i]);
  float lt = 0.f;
#pragma unroll
  for (int i = 0; i < NHW; ++i) lt += sm_l[i] * expf(sm_m[i] - mt);
  const float l1 = sm_l1;
  const float m_new = fmaxf(mt, l1);
  const float alpha = expf(mt - m_new), p1 = expf(l1 - m_new);
  const float inv = 1.f / fmaxf(lt * alpha + p1, 1e-30f);
  for (int e = tid; e < D; e += NT) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < NHW; ++i) a += sm_acc[i][e] * expf(sm_m[i] - mt);
    const float o = (a * alpha + p1 * __bfloat162float(p.v1[row + e])) * inv;
    if (p.q_f32)
      static_cast<float*>(p.out)[row + e] = o;
    else
      static_cast<bf16*>(p.out)[row + e] = __float2bfloat16(o);
  }
}

}  // namespace

// q, k1, v1, out: (B, H, D) contiguous (q and out bf16, or both fp32 with
// q_f32 = 1; k1, v1 bf16); k, v: bf16 caches of B x S rows x H heads x D
// with element strides (sb, ss, sh) and unit last stride, all multiples of
// 8 with 16-byte aligned bases; lengths (B,) int32, clipped to [0, S].
// D in {128, 256, 512}. Returns a cudaError_t (0 = launched).
extern "C" int gill_prefix_decode_attn(
    const void* q, const void* k1, const void* v1, const void* k,
    const void* v, const void* lengths, void* out, int q_f32, int B, int S,
    int H, int D, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 ||
      ((ksb | kss | ksh | vsb | vss | vsh) & 7))
    return (int)cudaErrorInvalidValue;
  Params p{q, static_cast<const bf16*>(k1), static_cast<const bf16*>(v1),
           static_cast<const bf16*>(k), static_cast<const bf16*>(v),
           static_cast<const int*>(lengths), out, ksb, kss, ksh, vsb, vss, vsh,
           B, S, H, q_f32, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * H);
  switch (D) {
    case 128: prefix_decode<1><<<grid, NT, 0, st>>>(p); break;
    case 256: prefix_decode<2><<<grid, NT, 0, st>>>(p); break;
    case 512: prefix_decode<4><<<grid, NT, 0, st>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
