"""Repeated-product tensor-core probe (S1): the hand-written CUDA kernel +
its plain version.

Counterpart of scripts/attn_mxu_probe.py `mk(m, k, n, dt, pet)`: out =
a @ b issued REPS times into one accumulator, a (M, K) and b (K, N), bf16
with fp32 sums (fp32 out) or int8 with int32 sums (int32 out). The probe
times it to read the tensor cores' rate with the operands on chip.

CUDA tensors launch csrc/mm_probe.cu (wgmma from shared memory, 64 x 128
output tiles, K in chunks of `mm_plan`'s bytes) or raise; CPU tensors take
`mm_probe_ref`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

REPS = 32            # the original's grid length
TILE = (64, 128)     # a block's output rows x columns (two warpgroups
                     # take its repetitions in turns)
CHUNK_BYTES = (512, 256, 128)   # the depth a block keeps, largest first
H100_SMS = 132
INT32_MAX = 2 ** 31 - 1


class ProbePlan(NamedTuple):
    """S1's launch: each block one 64 x 128 output tile over `chunk_bytes`
    of depth (K chunk `chunk_bytes` / element bytes), `chunks` of them
    summed in order by a second pass when more than one; `blocks`."""
    chunk_bytes: int
    chunks: int
    blocks: int


def mm_plan(m: int, k: int, n: int, dtype, num_sms: int = H100_SMS):
    """The largest K chunk (512, 256 or 128 bytes of depth, at most K's
    bytes rounded up to 128) whose tiles x chunks give at least 0.9 blocks
    an SM, else 128 bytes."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    es = 1 if dtype == torch.int8 else 2
    kbytes = -(-k * es // 16) * 16
    tiles = -(-m // TILE[0]) * -(-n // TILE[1])
    cap = -(-kbytes // 128) * 128
    for cb in CHUNK_BYTES:
        if cb > cap:
            continue
        chunks = -(-kbytes // cb)
        if tiles * chunks >= 0.9 * num_sms or cb == CHUNK_BYTES[-1]:
            return ProbePlan(cb, chunks, tiles * chunks)
    raise AssertionError("unreachable")


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
        fn.argtypes = [p, p, p, p] + [i] * 7 + [p]
        fn.restype = i
    return fn


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _pad_to(t, rows: int, cols: int):
    """t zero-padded to (rows, cols), contiguous and 16-byte aligned; t
    itself where it already is (every probe case)."""
    r, c = t.shape
    if (r, c) == (rows, cols) and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return F.pad(t, (0, cols - c, 0, rows - r)).contiguous()


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
    i8 = a.dtype == torch.int8
    # rows of 16-byte multiples for TMA and the 4-byte B loads (zeros are
    # exact); a no-op at every probe case
    step = 16 if i8 else 8
    kp, np_ = -(-k // step) * step, -(-n // step) * step
    a, b = _pad_to(a, m, kp), _pad_to(b, kp, np_)
    plan = mm_plan(m, kp, n, a.dtype, _num_sms(a.device.index or 0))
    odt = torch.int32 if i8 else torch.float32
    out = torch.empty((m, n), device=a.device, dtype=odt)
    part = torch.empty((plan.chunks, m, n), device=a.device, dtype=odt) \
        if plan.chunks > 1 else out
    err = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(), part.data_ptr(),
                 int(i8), m, n, kp, np_, plan.chunk_bytes, REPS,
                 torch.cuda.current_stream(a.device).cuda_stream)
    from gill_tpu_torch.ops._build import check

    check(err, "mm_probe")
    mm_probe.launches += 1
    return out


mm_probe.launches = 0
