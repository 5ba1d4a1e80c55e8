"""Repeated-product tensor-core probe (S1): the hand-written CUDA kernel +
its plain version.

Counterpart of scripts/attn_mxu_probe.py `mk(m, k, n, dt, pet)`: out =
a @ b issued REPS times into one accumulator, a (M, K) and b (K, N), bf16
with fp32 sums (fp32 out) or int8 with int32 sums (int32 out). The probe
times it to read the tensor cores' rate with the operands on chip.

CUDA tensors launch csrc/mm_probe.cu or raise; CPU tensors take
`mm_probe_ref`.
"""

from __future__ import annotations

import ctypes

import torch

REPS = 32            # the original's grid length
KC = 256             # the kernel's K chunk (a multiple of 16, at most 256)
INT32_MAX = 2 ** 31 - 1


def mm_probe_ref(a, b):
    """Plain version: REPS additions of the product. bf16: a.float() @
    b.float() in fp32, added in fp32. int8: the product in float64, exact
    for |a|, |b| <= 128 while K * 128**2 < 2**53 (CUDA has no int64
    matmul), then int64 sums; raises if a sum leaves the int32 range the
    kernel accumulates in."""
    if a.dtype == torch.int8:
        y = (a.double() @ b.double()).long()
        acc = torch.zeros_like(y)
        for _ in range(REPS):
            acc += y
        if int(acc.abs().max()) > INT32_MAX:
            raise OverflowError("a repeated int8 product leaves the int32 "
                                "range of its accumulator")
        return acc.to(torch.int32)
    y = a.float() @ b.float()
    acc = torch.zeros_like(y)
    for _ in range(REPS):
        acc += y
    return acc


def _lib():
    from gill_tpu_torch.ops import _build

    fn = _build.load("mm_probe").gill_mm_probe
    if fn.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [p, p, p, p] + [i] * 6 + [p]
        fn.restype = i
    return fn


def mm_probe(a, b):
    """REPS x (a @ b) accumulated, a (M, K), b (K, N), both bf16 (-> fp32)
    or both int8 (-> int32). Replaces scripts/attn_mxu_probe.py `mk`.
    CUDA tensors launch the kernel or raise; CPU tensors take
    `mm_probe_ref`."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes a {tuple(a.shape)} b {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"mm_probe takes bf16 or int8 operands, got "
                        f"{a.dtype}/{b.dtype}")
    if not a.is_cuda:
        return mm_probe_ref(a, b)
    if b.device != a.device:
        raise ValueError("a and b must share one device")
    m, k = a.shape
    n = b.shape[1]
    a, b = a.contiguous(), b.contiguous()
    i8 = a.dtype == torch.int8
    odt = torch.int32 if i8 else torch.float32
    kc = min(KC, -(-k // 16) * 16)
    chunks = -(-k // kc)
    out = torch.empty((m, n), device=a.device, dtype=odt)
    part = torch.empty((chunks, m, n), device=a.device, dtype=odt) \
        if chunks > 1 else out
    err = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(), part.data_ptr(),
                 int(i8), m, n, k, kc, REPS,
                 torch.cuda.current_stream(a.device).cuda_stream)
    from gill_tpu_torch.ops._build import check

    check(err, "mm_probe")
    mm_probe.launches += 1
    return out


mm_probe.launches = 0
