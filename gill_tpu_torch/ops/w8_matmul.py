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
of 512) in one launch at the geometry `w8_plan` gives, or raise; CPU
tensors take `w8_matmul_ref`. The wrapper allocates only the output.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

MAX_M = 256
_DIM_MULTIPLE = 512
H100_SMS = 132
BLOCK_NS = (64, 128)          # strip widths the tensor-core route takes
BLOCK_KS = (64, 128, 256)     # K rows of a pipeline stage
_RING_BYTES = 96 * 1024       # the TMA ring's target size
_MAX_STAGES = 8
_MAX_SPLITS = 8               # the portable thread-block cluster size
_CONSUMER_WARPS = 8


def supported(m: int, k: int, n: int) -> bool:
    """The kernel's scope: 1 <= M <= 256 rows, K and N multiples of 512."""
    return (1 <= m <= MAX_M and k > 0 and n > 0 and k % _DIM_MULTIPLE == 0
            and n % _DIM_MULTIPLE == 0)


class W8Plan(NamedTuple):
    """K4's launch for x (m, k) and w8 (k, n): `route` "mma" (bf16 x,
    mma.sync on the tensor cores) or "fma" (fp32 x, the CUDA cores); each
    block a strip of `block_n` output columns, fed `block_k` K rows a stage
    through a TMA ring of `stages` stages, `row_tile` rows of x a block;
    the K range split over the `splits` blocks of a cluster (summed in rank
    order in distributed shared memory); `blocks` blocks of nine warps
    (eight consumers and the producer); one kernel launch a call."""
    route: str
    block_n: int
    block_k: int
    stages: int
    splits: int
    row_tile: int
    blocks: int


def w8_plan(m: int, k: int, n: int, dtype, num_sms: int = H100_SMS,
            block_n=None, block_k=None) -> W8Plan:
    """The geometry csrc/w8_matmul.cu's `plan_for` gives (the C side
    refuses any other). Row tile: 8 / 16 / 128 rows for bf16 x at M <= 8 /
    <= 16 / above (the last: four warps of 32 rows, each over half of a
    stage's K rows), 1 / 4 for fp32 x at M = 1 / above. Strip width
    `block_n`: 64 or 128 (fp32: 128); by default 128 where 128-column
    strips alone give half the SMs a block (N 16384 at decode), else 64.
    Stage depth `block_k`: 64, 128 or 256 K rows, at least 16 a warp for
    bf16 x (128 at M <= 16); by default 256, 128 with 128-column bf16
    strips. Stages: as many as fit 96 KB (2-8), and enough to hold the
    warps' fp32 partials afterwards. The K tiles split over a cluster of
    min(8, num_sms // (strips x row blocks)) blocks, lowered until it
    divides them. Raises ValueError (TypeError for the dtype) for a call
    the kernel does not take."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w8_matmul kernel takes bf16 or fp32 x, got {dtype}")
    if not supported(m, k, n):
        raise ValueError(f"w8_matmul kernel takes 1 <= M <= {MAX_M} and K, N "
                         f"multiples of {_DIM_MULTIPLE}; got M={m} K={k} "
                         f"N={n}")
    fp32 = dtype == torch.float32
    mt = (1 if m == 1 else 4) if fp32 else (8 if m <= 8 else
                                            16 if m <= 16 else 128)
    wide = fp32 or (mt <= 16 and -(-m // mt) * (n // 128) * 2 >= num_sms)
    bn = (128 if wide else 64) if block_n is None else block_n
    bk = (128 if wide and not fp32 else 256) if block_k is None else block_k
    if bn not in ((128,) if fp32 else BLOCK_NS):
        raise ValueError(f"w8_matmul block_n must be one of "
                         f"{(128,) if fp32 else BLOCK_NS} for {dtype} x, "
                         f"got {block_n}")
    if bk not in BLOCK_KS:
        raise ValueError(f"w8_matmul block_k must be one of {BLOCK_KS}, got "
                         f"{block_k}")
    # the tensor-core warps take >= 16 K rows of a stage each
    k_warps = _CONSUMER_WARPS // 4 if mt == 128 else _CONSUMER_WARPS
    if not fp32 and bk < 16 * k_warps:
        raise ValueError(f"w8_matmul block_k must be >= {16 * k_warps} for "
                         f"bf16 x at M = {m}, got {block_k}")
    base = -(-m // mt) * (n // bn)
    tiles = k // bk
    splits = max(1, min(_MAX_SPLITS, num_sms // base))
    while tiles % splits:
        splits -= 1
    stage = -(-(bk * bn + mt * bk * (4 if fp32 else 2)) // 1024) * 1024
    stages = max(2, min(_MAX_STAGES, _RING_BYTES // stage))
    # the ring also holds the warps' partials after the loop
    stages = max(stages, -(-(k_warps * mt * bn * 4) // stage))
    return W8Plan("fma" if fp32 else "mma", bn, bk, stages, splits, mt,
                  base * splits)


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
        lib.gill_w8_matmul.argtypes = [i, p, p, ll, p, p, i, p] + [i] * 9 \
            + [p]
        lib.gill_w8_matmul.restype = i
        lib.gill_w8_plan.argtypes = [i] * 7 + [ctypes.POINTER(ctypes.c_int)]
        lib.gill_w8_plan.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def c_plan(m: int, k: int, n: int, dtype, num_sms: int, block_n=None,
           block_k=None):
    """(block_n, block_k, stages, splits, row_tile, blocks) as the C side
    plans them, or None where it refuses the call (builds the library)."""
    out = (ctypes.c_int * 6)()
    err = _lib().gill_w8_plan(m, k, n, int(dtype == torch.float32), num_sms,
                              block_n or 0, block_k or 0, out)
    return None if err else tuple(out)


_BIAS_KIND = {torch.float32: 1, torch.bfloat16: 2}


def w8_matmul(x, w8, ws, b=None, *, block_n=None, block_k=None):
    """x (..., K) -> (..., N) in x's dtype. Replaces gill_tpu `w8_matmul`
    (Pallas `_kernel`). `block_n` / `block_k` pick the strip width and the
    K rows of a stage on the card (`w8_plan`); on the CPU they change
    nothing, but values the kernel does not take raise there too."""
    kdim, n = w8.shape
    m = x.numel() // kdim if kdim else 0
    if not x.is_cuda:
        if block_n is not None or block_k is not None:
            w8_plan(m, kdim, n, x.dtype, block_n=block_n, block_k=block_k)
        return w8_matmul_ref(x, w8, ws, b)
    if x.shape[-1] != kdim:
        raise ValueError(f"x {tuple(x.shape)} does not match w8 "
                         f"{tuple(w8.shape)}")
    plan = w8_plan(m, kdim, n, x.dtype, _num_sms(x.device.index or 0),
                   block_n, block_k)
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
    err = _lib().gill_w8_matmul(
        int(plan.route == "fma"), x2.data_ptr(), w8.data_ptr(), w8.stride(0),
        ws.data_ptr(), None if b is None else b.data_ptr(),
        0 if b is None else _BIAS_KIND[b.dtype], out.data_ptr(), m, kdim, n,
        _num_sms(x.device.index or 0), plan.block_n, plan.block_k,
        plan.stages, plan.splits, plan.row_tile,
        torch.cuda.current_stream(x.device).cuda_stream)
    from gill_tpu_torch.ops._build import check

    check(err, "w8_matmul")
    w8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], n)


w8_matmul.launches = 0


def w8_matmul_stacked(x, w8, ws, b, idx: int, *, block_n=None, block_k=None):
    """gill_tpu `w8_matmul_stacked`: layer `idx` of a stacked (L, K, N)
    int8 weight; ws and b are that layer's (N,) rows. The slice is a view,
    so this is `w8_matmul` on it (same kernel, same launch count)."""
    return w8_matmul(x, w8[idx], ws, b, block_n=block_n, block_k=block_k)
