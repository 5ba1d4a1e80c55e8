// Valid-prefix single-token decode attention for Hopper (sm_90a), split
// along the cache rows (flash-decoding) over the blocks of a cluster.
//
// Replaces gill_tpu/ops/decode_attn.py `prefix_decode_attention` (Pallas
// `_kernel`): for each batch row b and head h,
//   out = softmax over [q . k_s * scale for s < len_b] + [q . k1 * scale]
//         applied to [v_s for s < len_b] + [v1],
// an exact softmax in fp32 over the first len_b = clip(lengths[b], 0, S)
// rows of a bf16 (B, S, H, D) cache plus the token's own (k1, v1), which
// never enters the cache here; len_b = 0 gives v1. q may be bf16 or fp32;
// the output is in q's dtype.
//
// What bounds it on an H100: the valid cache rows. A step reads
// sum_b len_b * H * D * 2 (k and v) * 2 bytes a layer and does ~4 FLOPs a
// byte. The serving engines' slots are uneven (parked rows read nothing,
// full ones read the whole window), so a design that walks a row's prefix
// in one block ends on the longest rows' dependent chains while the rest
// of the card idles, and the few SMs still busy at the end must each read
// far faster than an even share of the memory rate. Design:
//  * the grid is (splits, H / heads, B): block (j, g, b) reads rows
//    [j rows, (j + 1) rows) of row b's valid prefix for the `heads` heads
//    of group g, a contiguous heads x D slice of each cache row (1 KB at
//    D = 128 and four heads, where one head's strip is 256 bytes of an 8 KB
//    row). The plan (`plan_for`, exported as gill_decode_plan and mirrored
//    by ops/decode_attn.py `decode_plan`) comes from the bucket S, B, H, D
//    and the SM count, never from `lengths`, which stay on the device:
//    fewer heads a block where the head groups alone leave the card under
//    half full, then as many splits (<= 8, >= 128 rows each) as one wave
//    of resident blocks (2 an SM) holds. A split that starts at or past
//    len_b reads nothing and contributes (m = -1e30, l = 0, acc = 0);
//  * a 3-stage ring of 32 KB K/V tiles in shared memory (16 rows of the
//    slice at four heads), filled with 16-byte cp.async by every thread
//    (4 a thread a stage, fixed offsets), so two stages (64 KB) are in
//    flight while one is used; rows past the split's valid end are not
//    copied. (1-D bulk copies, one a row slice, are issued one at a time
//    and cap a block far lower; the pool view's base changes with every
//    layer and read window, so a TMA tensor map would cost a host encode
//    each call);
//  * 8 warps; a warp owns whole rows of a stage (warp w rows w and w + 8)
//    and lane l the elements [l E, l E + E) of the row slice (E = heads x
//    D / 32), so a head's dot product is reduced over D / E lanes (8 at
//    D = 128: three shuffles a row for four heads). Each warp keeps an
//    exact online softmax a head (fp32 running max, sum and accumulator,
//    in base 2; q . k on the CUDA cores: M = 1 a head leaves the tensor
//    cores nothing to do); a row past the valid end is skipped whole;
//  * the warps of a block merge through shared memory in warp order, then
//    the splits of one (b, head group), the blocks of one thread-block
//    cluster, merge over distributed shared memory in rank order (rank r
//    computes its share of the heads x D outputs); the own token folds in
//    after the merge, as the Pallas kernel does. One launch a call, no
//    workspace, the same bits run to run;
//  * the cache is a strided view (a layer and a read window of the
//    (L, B, S, H, D) pool): the kernel takes its strides, no copy is made.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;            // 8 warps
constexpr int NW = NT / 32;
constexpr int ST = 3;              // ring stages
constexpr int STAGE_BYTES = 32768; // k and v rows of one stage
constexpr int MAX_SPLITS = 8;      // the portable cluster size
constexpr int MIN_ROWS = 128;      // fewest cache rows a split takes
constexpr int BLOCKS_PER_SM = 2;   // 96 KB of ring and <= 128 registers
constexpr int ROW_ELEMS = 512;     // a block's row slice: heads x D <= 512
constexpr float NEG = -1e30f;      // gill_tpu's _NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

struct Plan {
  int heads, splits, rows, tile_rows, blocks;
};

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// the launch for (B, S, H, D) on a card with `sms` SMs; false when the
// kernel does not take the call
bool plan_for(int B, int S, int H, int D, int sms, Plan* p) {
  if (B < 1 || S < 1 || H < 1 || sms < 1 ||
      (D != 128 && D != 256 && D != 512) || B > 65535)
    return false;
  int hg = ROW_ELEMS / D;
  while (H % hg) hg /= 2;
  // the resident blocks: a plan past one wave waits for a second
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  // fewer heads a block where even the most splits leave the card under
  // half full
  while (hg > 1 && 2LL * B * (H / hg) * MAX_SPLITS < cap) hg /= 2;
  if (H / hg > 65535) return false;
  const long long pairs = (long long)B * (H / hg);
  long long sp = cap / pairs;
  sp = sp < MAX_SPLITS ? sp : MAX_SPLITS;
  const long long by_rows = ceil_div(S, MIN_ROWS);
  sp = sp < by_rows ? sp : by_rows;
  sp = sp > 1 ? sp : 1;
  // rows a split, a multiple of 8; the splits that leaves
  const int rows = (int)(ceil_div(ceil_div(S, sp), 8) * 8);
  p->heads = hg;
  p->splits = (int)ceil_div(S, rows);
  p->rows = rows;
  p->tile_rows = STAGE_BYTES / 4 / (hg * D);
  p->blocks = (int)(pairs * p->splits);
  return true;
}

struct Params {
  const void* q;                 // (B, H, D), bf16 or fp32
  const bf16* k1;                // (B, H, D)
  const bf16* v1;
  const bf16* kc;                // cache views, element strides below
  const bf16* vc;
  const int* lengths;            // (B,)
  void* out;                     // (B, H, D), q's dtype
  long long ksb, kss, ksh, vsb, vss, vsh;
  int S, H, q_f32, rows;
  float scale;
};

// PE bf16 (8 or 4) loaded as one 16- or 8-byte word
template <int PE>
using Raw = std::conditional_t<PE == 8, uint4, uint2>;

template <int PE>
__device__ __forceinline__ Raw<PE> load_raw(const bf16* p) {
  return *reinterpret_cast<const Raw<PE>*>(p);
}

// the PE bf16 of a word widened to fp32
template <int PE>
__device__ __forceinline__ void widen(const Raw<PE>& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < PE / 2; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

// a lane's share of q . k over its NP words of k, in four independent
// chains (element j in chain j % 4) summed pairwise
template <int NP, int PE>
__device__ __forceinline__ float lane_dot(const float (&qf)[NP][PE],
                                          const Raw<PE> (&kr)[NP]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float kf[PE];
    widen<PE>(kr[i], kf);
#pragma unroll
    for (int j = 0; j < PE; ++j) d[j & 3] = fmaf(qf[i][j], kf[j], d[j & 3]);
  }
  return (d[0] + d[1]) + (d[2] + d[3]);
}

// sum over the aligned groups of L lanes (xor offsets below L stay inside)
template <int L>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// D: head dim; RE: the row slice a block reads (heads x D)
template <int D, int RE>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
    prefix_decode_split(Params p) {
  constexpr int HG = RE / D;                  // heads a block
  constexpr int E = RE / 32;                  // elements a lane: 16, 8, 4
  constexpr int PE = E < 8 ? E : 8;           // elements a load
  constexpr int NP = E / PE;                  // loads a lane a row
  constexpr int LPH = D / E;                  // lanes a head
  constexpr int T = STAGE_BYTES / 4 / RE;     // rows a stage
  constexpr int U = T / NW;                   // rows a warp a stage
  constexpr int STAGE = STAGE_BYTES / 2;      // bf16 elements a stage
  static_assert(U >= 1 && T % NW == 0, "a stage gives each warp a row");
  extern __shared__ __align__(128) unsigned char smem[];
  // the warps' per-head (max, sum); the block's, read by the cluster; the
  // own token's logit; the merge's per-head factors
  __shared__ float sm_m[NW][HG], sm_l[NW][HG], blk_m[HG], blk_l[HG];
  __shared__ float sm_l1[HG], sm_w[HG][MAX_SPLITS], sm_f[HG][3];

  const int split = blockIdx.x, h0 = blockIdx.y * HG, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hh = lane / LPH;                  // the lane's head in the group
  // the lane's loads: elements off[i] + [0, PE) of the row slice. At E =
  // 16, lanes of a quarter-warp take their two 16-byte pieces in opposite
  // order by lane / 4, so each load instruction's 8 pieces of a quarter
  // fall in 8 distinct bank groups
  int off[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i)
    off[i] = lane * E + PE * (NP == 2 ? (i ^ ((lane >> 2) & 1)) : i);

  int n = p.lengths[b];
  n = n < 0 ? 0 : (n > p.S ? p.S : n);
  const int r0 = split * p.rows;
  const int r1 = min(r0 + p.rows, n);
  const int nt = r1 > r0 ? (r1 - r0 + T - 1) / T : 0;

  const long long qrow = ((long long)b * p.H + h0) * D;
  float qf[NP][PE];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (p.q_f32) {
      const float* qp = static_cast<const float*>(p.q) + qrow + off[i];
#pragma unroll
      for (int j = 0; j < PE; ++j) qf[i][j] = qp[j];
    } else {
      widen<PE>(load_raw<PE>(static_cast<const bf16*>(p.q) + qrow + off[i]),
                qf[i]);
    }
  }

  // the ring, [ST][k, v][T][RE]: thread tid copies 16-byte chunk x =
  // tid % (RE / 8) of tensor (tid / (RE / 8)) % 2 for rows tid / (RE / 4)
  // + RSTEP j, j < CPT, of each stage (2048 chunks, 8 a thread)
  constexpr int CPR = RE / 8, RSTEP = NT / (2 * CPR), CPT = 2 * T * CPR / NT;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int cx = tid % CPR, ctv = (tid / CPR) & 1, crow = tid / (2 * CPR);
  const long long css = ctv ? p.vss : p.kss;
  const bf16* gsrc = (ctv ? p.vc + b * p.vsb + (h0 + cx / (D / 8)) * p.vsh
                          : p.kc + b * p.ksb + (h0 + cx / (D / 8)) * p.ksh) +
                     (cx % (D / 8)) * 8 + (long long)(r0 + crow) * css;
  bf16* cdst = ring + (ctv * T + crow) * RE + cx * 8;
  // stage t into slot t % ST: this thread's chunks of the valid rows
  auto fill = [&](int t) {
    const bf16* src = gsrc + (long long)t * T * css;
    bf16* dst = cdst + (t % ST) * STAGE;
    const int row = r0 + t * T + crow;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      if (row + RSTEP * j < r1)
        cp_async16(dst + RSTEP * j * RE, src + RSTEP * j * css);
  };

  const float sl = p.scale * LOG2E;           // logits in base 2
  float m = NEG, l = 0.f, acc[NP][PE];
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j < PE; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < nt) fill(t);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait_prior<ST - 2>();
    // every thread's copies of stage t have landed, and every warp is
    // done with stage t - 1, whose slot the next fill takes
    __syncthreads();
    if (t + ST - 1 < nt) fill(t + ST - 1);
    cp_async_commit();
    const bf16* ks = ring + (t % ST) * STAGE;
    const bf16* vs = ks + T * RE;
    const int nv = min(T, r1 - (r0 + t * T));
    // this warp's rows of the stage: k and v words loaded together, then
    // the logits, then the running max
    float sc[U], mx = m;
    Raw<PE> vr[U][NP];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = warp + NW * u;
      sc[u] = NEG;
      if (r < nv) {                           // warp-uniform
        Raw<PE> kr[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          kr[i] = load_raw<PE>(ks + r * RE + off[i]);
          vr[u][i] = load_raw<PE>(vs + r * RE + off[i]);
        }
        sc[u] = group_sum<LPH>(lane_dot(qf, kr)) * sl;
        mx = fmaxf(mx, sc[u]);
      }
    }
    if (mx != m) {                            // the running max rose
      const float alpha = ex2(m - mx);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int j = 0; j < PE; ++j) acc[i][j] *= alpha;
      m = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (warp + NW * u < nv) {               // warp-uniform (v)
        const float pu = ex2(sc[u] - m);
        l += pu;
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          float vf[PE];
          widen<PE>(vr[u][i], vf);
#pragma unroll
          for (int j = 0; j < PE; ++j) acc[i][j] = fmaf(pu, vf[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait_prior<0>();
  __syncthreads();                 // the ring is free: partials go there

  // the warps' states, then each head's merged over the warps in order:
  // part [NW][RE], blk [RE]
  float* part = reinterpret_cast<float*>(smem);
  float* blk = part + NW * RE;
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j < PE; ++j) part[warp * RE + off[i] + j] = acc[i][j];
  if (lane % LPH == 0) {
    sm_m[warp][hh] = m;
    sm_l[warp][hh] = l;
  }
  if (warp == 0) {                 // the own token's logit, base 2
    Raw<PE> kr[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) kr[i] = load_raw<PE>(p.k1 + qrow + off[i]);
    const float d = group_sum<LPH>(lane_dot(qf, kr)) * sl;
    if (lane % LPH == 0) sm_l1[hh] = d;
  }
  __syncthreads();
  for (int e = tid; e < RE; e += NT) {
    const int h = e / D;
    float mt = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) mt = fmaxf(mt, sm_m[w][h]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a += part[w * RE + e] * ex2(sm_m[w][h] - mt);
    blk[e] = a;
  }
  if (tid < HG) {
    float mt = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) mt = fmaxf(mt, sm_m[w][tid]);
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) lt += sm_l[w][tid] * ex2(sm_m[w][tid] - mt);
    blk_m[tid] = mt;
    blk_l[tid] = lt;
  }

  // the splits' partials, merged in rank order; rank r computes outputs
  // [r w, r w + w) of the block's heads x D, w = ceil(heads D / splits)
  const int splits = gridDim.x;
  cg::cluster_group cl = cg::this_cluster();
  if (splits > 1)
    cl.sync();
  else
    __syncthreads();
  if (tid < HG) {
    float mr[MAX_SPLITS], mt = NEG;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      mr[j] = NEG;
      if (j < splits) {
        mr[j] = splits > 1 ? cl.map_shared_rank(blk_m, j)[tid] : blk_m[tid];
        mt = fmaxf(mt, mr[j]);
      }
    }
    float lt = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      if (j < splits) {
        const float w = ex2(mr[j] - mt);
        sm_w[tid][j] = w;
        lt += (splits > 1 ? cl.map_shared_rank(blk_l, j)[tid] : blk_l[tid]) * w;
      }
    }
    const float l1 = sm_l1[tid];
    const float m_new = fmaxf(mt, l1);
    const float alpha = ex2(mt - m_new), p1 = ex2(l1 - m_new);
    sm_f[tid][0] = alpha;
    sm_f[tid][1] = p1;
    sm_f[tid][2] = fmaxf(lt * alpha + p1, 1e-30f);
  }
  __syncthreads();
  const int rank = splits > 1 ? (int)cl.block_rank() : 0;
  const int share = (RE + splits - 1) / splits;
  const int e1 = min(RE, (rank + 1) * share);
  for (int e = rank * share + tid; e < e1; e += NT) {
    const int h = e / D;
    float a = 0.f;
    for (int j = 0; j < splits; ++j)
      a += (splits > 1 ? cl.map_shared_rank(blk, j)[e] : blk[e]) * sm_w[h][j];
    const long long o = qrow + e;
    const float y = (a * sm_f[h][0] + sm_f[h][1] * __bfloat162float(p.v1[o])) /
                    sm_f[h][2];
    if (p.q_f32)
      static_cast<float*>(p.out)[o] = y;
    else
      static_cast<bf16*>(p.out)[o] = __float2bfloat16(y);
  }
  if (splits > 1) cl.sync();       // no block leaves while others read it
}

template <int D, int RE>
cudaError_t launch_t(const Params& prm, const Plan& pl, int B,
                     cudaStream_t st) {
  constexpr int smem = ST * STAGE_BYTES;
  static const cudaError_t e0 = cudaFuncSetAttribute(
      prefix_decode_split<D, RE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e0 != cudaSuccess) return e0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.splits, prm.H / pl.heads, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.splits > 1 ? 1 : 0;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, prefix_decode_split<D, RE>, prm);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// the instantiation for head dim D and a row slice of heads x D
cudaError_t launch(const Params& prm, const Plan& pl, int B, int D,
                   cudaStream_t st) {
  switch (D * 8 + pl.heads) {
    case 128 * 8 + 1: return launch_t<128, 128>(prm, pl, B, st);
    case 128 * 8 + 2: return launch_t<128, 256>(prm, pl, B, st);
    case 128 * 8 + 4: return launch_t<128, 512>(prm, pl, B, st);
    case 256 * 8 + 1: return launch_t<256, 256>(prm, pl, B, st);
    case 256 * 8 + 2: return launch_t<256, 512>(prm, pl, B, st);
    case 512 * 8 + 1: return launch_t<512, 512>(prm, pl, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The plan gill_prefix_decode_attn takes for (B, S, H, D) on a card with
// `sms` SMs: out[0..4] = heads a block, splits, rows a split, rows a ring
// stage, blocks. Returns 0, or cudaErrorInvalidValue when the kernel does
// not take the call.
extern "C" int gill_decode_plan(int B, int S, int H, int D, int sms,
                                int* out) {
  Plan p;
  if (!plan_for(B, S, H, D, sms, &p)) return (int)cudaErrorInvalidValue;
  const int v[5] = {p.heads, p.splits, p.rows, p.tile_rows, p.blocks};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// q, k1, v1, out: (B, H, D) contiguous (q and out bf16, or both fp32 with
// q_f32 = 1; k1, v1 bf16); k, v: bf16 caches of B x S rows x H heads x D
// with element strides (sb, ss, sh) and unit last stride, all multiples of
// 8 with 16-byte aligned bases; lengths (B,) int32, clipped to [0, S].
// D in {128, 256, 512}. heads, splits and rows must be the plan
// gill_decode_plan gives for (B, S, H, D, sms). One launch. Returns a
// cudaError_t (0 = launched; an invalid value also for any other plan).
extern "C" int gill_prefix_decode_attn(
    const void* q, const void* k1, const void* v1, const void* k,
    const void* v, const void* lengths, void* out, int q_f32, int B, int S,
    int H, int D, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, float scale, int sms, int heads,
    int splits, int rows, void* stream) {
  Plan pl;
  if (!plan_for(B, S, H, D, sms, &pl) || pl.heads != heads ||
      pl.splits != splits || pl.rows != rows ||
      ((ksb | kss | ksh | vsb | vss | vsh) & 7))
    return (int)cudaErrorInvalidValue;
  Params p{q, static_cast<const bf16*>(k1), static_cast<const bf16*>(v1),
           static_cast<const bf16*>(k), static_cast<const bf16*>(v),
           static_cast<const int*>(lengths), out, ksb, kss, ksh, vsb, vss, vsh,
           S, H, q_f32, rows, scale};
  return (int)launch(p, pl, B, D, static_cast<cudaStream_t>(stream));
}
