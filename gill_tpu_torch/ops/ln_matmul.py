"""LayerNorm folded into a bias-free matmul: the hand-written CUDA kernel +
its plain version.

Counterpart of gill_tpu/ops/ln_matmul.py (`ln_matmul`, Pallas `_kernel`,
and `ln_matmul_stacked`, `_kernel_stacked`), the SD UNet's q/k/v
projections under GILL_SD_FUSE_LN=1: out[k] = LN(x) @ ws[k], with the
normalized x kept on the SM. The stacked form multiplies one normalized
tile by all K weights, so the self-attention q, k and v read x once and
come out as contiguous leading-axis slices of one (K, M, n) tensor.

The LayerNorm is gill_tpu's `_ln_rows`: mean and E[x^2] of the fp32 x
(squared in fp32), the variance clamped at 0, inv = rsqrt(var + eps),
a = bf16(inv * gamma), sh = bf16(beta - mean * inv * gamma), then x * a + sh
in x's dtype. (nn.core.layer_norm squares in x's dtype instead; the two
agree in fp32.)

CUDA tensors launch csrc/ln_matmul.cu (bf16, d in {320, 640}, n a multiple
of 64, K <= 3) or raise; CPU tensors take the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from gill_tpu_torch.ops.geglu import _aligned

SUPPORTED_DIMS = (320, 640)
MAX_STACK = 3


def ln_rows(x, gamma, beta, eps: float = 1e-5):
    """gill_tpu `_ln_rows` over the last axis, in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    mean2 = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    gf = gamma.float()
    a = (inv * gf).to(x.dtype)
    sh = (beta.float() - mean * inv * gf).to(x.dtype)
    return x * a + sh


def ln_matmul_ref(x, gamma, beta, w, eps: float = 1e-5):
    """x (..., d), w (d, n) -> LN(x) @ w in x's dtype, shape (..., n)."""
    return ln_rows(x, gamma, beta, eps) @ w.to(x.dtype)


def ln_matmul_stacked_ref(x, gamma, beta, ws, eps: float = 1e-5):
    """x (..., d), ws (K, d, n) -> (K, ..., n), out[k] = LN(x) @ ws[k]."""
    xn = ln_rows(x, gamma, beta, eps)
    return torch.stack([xn @ w.to(x.dtype) for w in ws.unbind(0)])


def _lib():
    from gill_tpu_torch.ops import _build

    lib = _build.load("ln_matmul")
    fn = lib.gill_ln_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def _launch(x, gamma, beta, ws, eps: float, what: str):
    """ws (K, d, n) -> (K, M, n) on the card: the checks, then one launch."""
    d = x.shape[-1]
    kk, wd, n = ws.shape
    if d not in SUPPORTED_DIMS:
        raise ValueError(f"{what} kernel takes d in {SUPPORTED_DIMS}, got {d}")
    if wd != d or n % 64 or not 1 <= kk <= MAX_STACK:
        raise ValueError(f"{what}: weights {tuple(ws.shape)} for d {d} "
                         f"(n a multiple of 64, at most {MAX_STACK} stacked)")
    if tuple(gamma.shape) != (d,) or tuple(beta.shape) != (d,):
        raise ValueError(f"{what}: gamma/beta must be ({d},)")
    tensors = (x, gamma, beta, ws)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"{what} kernel takes bf16 tensors")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{what} tensors must share one device")
    x2, gamma, beta, ws = (_aligned(t) for t in (x.reshape(-1, d), gamma,
                                                  beta, ws))
    m = x2.shape[0]
    out = torch.empty((kk, m, n), device=x.device, dtype=x.dtype)
    if m:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib()(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                     ws.data_ptr(), out.data_ptr(), m, d, n, kk, float(eps),
                     stream)
        from gill_tpu_torch.ops._build import check

        check(err, what)
    return out


def ln_matmul(x, gamma, beta, w, *, eps: float = 1e-5):
    """x (..., d), gamma/beta (d,), w (d, n) -> LN(x) @ w, (..., n), no
    bias (the SD q/k/v projections have none). Replaces gill_tpu
    `ln_matmul` (Pallas `_kernel`)."""
    if not x.is_cuda:
        return ln_matmul_ref(x, gamma, beta, w, eps)
    out = _launch(x, gamma, beta, w[None], eps, "ln_matmul")
    ln_matmul.launches += 1
    return out[0].reshape(*x.shape[:-1], w.shape[-1])


def ln_matmul_stacked(x, gamma, beta, ws, *, eps: float = 1e-5):
    """x (..., d), ws (K, d, n) -> (K, ..., n), out[k] = LN(x) @ ws[k],
    x read once. Replaces gill_tpu `ln_matmul_stacked` (Pallas
    `_kernel_stacked`)."""
    if not x.is_cuda:
        return ln_matmul_stacked_ref(x, gamma, beta, ws, eps)
    out = _launch(x, gamma, beta, ws, eps, "ln_matmul_stacked")
    ln_matmul_stacked.launches += 1
    return out.reshape(ws.shape[0], *x.shape[:-1], ws.shape[-1])


ln_matmul.launches = 0
ln_matmul_stacked.launches = 0
