// Shared helpers for the gill_tpu_torch CUDA kernels (plain C interface,
// built by gill_tpu_torch/ops/_build.py with nvcc for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16-byte global -> shared copies that bypass the registers (cp.async),
// committed in groups; wait_prior<N> waits until at most N groups are in
// flight
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// LayerNorm, in place, of `rows` resident bf16 rows of width D (row stride
// `ld` elements, 16-byte aligned rows), with the rounding points of
// gill_tpu/ops/ln_matmul.py `_ln_rows`: mean and E[x^2] of the fp32 x
// (squared in fp32), the variance clamped at 0, inv = rsqrt(var + eps),
// a = bf16(inv * gamma), sh = bf16(beta - mean * inv * gamma), then
// bf16(bf16(x * a) + sh). One warp a row; gamma and beta are bf16 (D,),
// 16-byte aligned. The _rn intrinsics keep the compiler from contracting
// products into fused multiply-adds the reference does not make.
template <int D>
__device__ __forceinline__ void ln_rows_inplace(
    bf16* xs, int ld, int rows, const bf16* __restrict__ gamma,
    const bf16* __restrict__ beta, float eps, int warp, int nwarps,
    int lane) {
  static_assert(D % 8 == 0, "row width");
  for (int r = warp; r < rows; r += nwarps) {
    bf16* row = xs + r * ld;
    float s = 0.f, s2 = 0.f;
    for (int c = lane * 8; c < D; c += 256) {
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
    const float mean = __fdiv_rn(s, (float)D);
    const float mean2 = __fdiv_rn(s2, (float)D);
    const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
    const float inv = __frsqrt_rn(__fadd_rn(var, eps));
    const float mi = __fmul_rn(mean, inv);
    for (int c = lane * 8; c < D; c += 256) {
      uint4 v = *reinterpret_cast<const uint4*>(row + c);
      const uint4 gv = *reinterpret_cast<const uint4*>(gamma + c);
      const uint4 bv = *reinterpret_cast<const uint4*>(beta + c);
      bf16* e = reinterpret_cast<bf16*>(&v);
      const bf16* g = reinterpret_cast<const bf16*>(&gv);
      const bf16* b = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float gf = __bfloat162float(g[j]);
        const float a = __bfloat162float(__float2bfloat16(__fmul_rn(inv, gf)));
        const float sh = __bfloat162float(__float2bfloat16(
            __fsub_rn(__bfloat162float(b[j]), __fmul_rn(mi, gf))));
        const float xa =
            __bfloat162float(__float2bfloat16(__fmul_rn(__bfloat162float(e[j]), a)));
        e[j] = __float2bfloat16(__fadd_rn(xa, sh));
      }
      *reinterpret_cast<uint4*>(row + c) = v;
    }
  }
}
