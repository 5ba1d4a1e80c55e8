"""W8A16 matmul: the hand-written CUDA kernel + its plain version.

Counterpart of gill_tpu/ops/w8_matmul.py. Computes
    y = (x @ w8) * ws + b
for x (..., K) in bf16 or fp32, w8 (K, N) int8 with per-output-channel
fp32 scales ws (N,) applied once after the K-sum, an optional bias b (N,),
fp32 accumulation and one rounding to x's dtype. gill_tpu's stacked
variant indexes an (L, K, N) stack inside its BlockSpec because XLA would
copy the slice `w8[idx]`; in PyTorch that slice is a view, so
`w8_matmul_stacked` is `w8_matmul` on it, with the same kernel and no copy.

CUDA tensors launch csrc/w8_matmul.cu (M <= 256 rows, K and N multiples
of 512) or raise; CPU tensors take `w8_matmul_ref`.
"""

from __future__ import annotations

import ctypes

import torch

MAX_M = 256
_DIM_MULTIPLE = 512


def supported(m: int, k: int, n: int) -> bool:
    """The kernel's scope: 1 <= M <= 256 rows, K and N multiples of 512."""
    return (1 <= m <= MAX_M and k % _DIM_MULTIPLE == 0
            and n % _DIM_MULTIPLE == 0)


def w8_matmul_ref(x, w8, ws, b=None):
    """Plain version with the kernel's arithmetic: fp32 products and sums,
    the scale after the K-sum, the bias in fp32, one rounding to x's
    dtype."""
    y = torch.matmul(x.float(), w8.float()) * ws.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _lib():
    from gill_tpu_torch.ops import _build

    lib = _build.load("w8_matmul")
    if lib.gill_w8_matmul.argtypes is None:
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.gill_w8_matmul.argtypes = [i, p, p, ll, p, p, i, p, p, i, i, i,
                                       i, p]
        lib.gill_w8_matmul.restype = i
        lib.gill_w8_matmul_splits.argtypes = [i, i, i, i, i]
        lib.gill_w8_matmul_splits.restype = i
    return lib


_BIAS_KIND = {torch.float32: 1, torch.bfloat16: 2}


def w8_matmul(x, w8, ws, b=None):
    """x (..., K) -> (..., N) in x's dtype. Replaces gill_tpu `w8_matmul`
    (Pallas `_kernel`)."""
    if not x.is_cuda:
        return w8_matmul_ref(x, w8, ws, b)
    kdim, n = w8.shape
    m = x.numel() // kdim if kdim else 0
    if x.shape[-1] != kdim:
        raise ValueError(f"x {tuple(x.shape)} does not match w8 "
                         f"{tuple(w8.shape)}")
    if not supported(m, kdim, n):
        raise ValueError(f"w8_matmul kernel takes 1 <= M <= {MAX_M} and K, N "
                         f"multiples of {_DIM_MULTIPLE}; got M={m} K={kdim} "
                         f"N={n}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"w8_matmul kernel takes bf16 or fp32 x, got {x.dtype}")
    if w8.dtype != torch.int8 or ws.dtype != torch.float32 \
            or tuple(ws.shape) != (n,):
        raise TypeError(f"w8 must be int8 and ws (N,) fp32, got {w8.dtype} "
                        f"and {ws.dtype} {tuple(ws.shape)}")
    if b is not None and (b.dtype not in _BIAS_KIND or tuple(b.shape) != (n,)):
        raise TypeError(f"b must be (N,) fp32 or bf16, got {b.dtype} "
                        f"{tuple(b.shape)}")
    tensors = (x, w8, ws) + (() if b is None else (b,))
    if any(t.device != x.device for t in tensors):
        raise ValueError("w8_matmul tensors must share one device")
    if w8.stride(1) != 1 or w8.stride(0) % 16 or w8.data_ptr() % 16:
        raise ValueError("w8 rows must be unit-stride with 16-byte aligned "
                         f"starts, got strides {w8.stride()}")
    x2 = x.reshape(m, kdim)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    ws = ws.contiguous()
    b = None if b is None else b.contiguous()
    out = torch.empty((m, n), device=x.device, dtype=x.dtype)
    lib = _lib()
    is_f32 = int(x.dtype == torch.float32)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = lib.gill_w8_matmul_splits(m, kdim, n, is_f32, sms)
    part = (torch.empty((splits, m, n), device=x.device, dtype=torch.float32)
            if splits > 1 else None)
    err = lib.gill_w8_matmul(
        is_f32, x2.data_ptr(), w8.data_ptr(), w8.stride(0), ws.data_ptr(),
        None if b is None else b.data_ptr(),
        0 if b is None else _BIAS_KIND[b.dtype], out.data_ptr(),
        None if part is None else part.data_ptr(), m, kdim, n, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    from gill_tpu_torch.ops._build import check

    check(err, "w8_matmul")
    w8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], n)


w8_matmul.launches = 0


def w8_matmul_stacked(x, w8, ws, b, idx: int):
    """gill_tpu `w8_matmul_stacked`: layer `idx` of a stacked (L, K, N)
    int8 weight; ws and b are that layer's (N,) rows. The slice is a view,
    so this is `w8_matmul` on it (same kernel, same launch count)."""
    return w8_matmul(x, w8[idx], ws, b)
