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
of 64, K <= 3) or raise; CPU tensors take the plain versions. The kernel is
K3's tensor-core GEMM (csrc/wg_gemm.cuh) after a pass that writes each
row's (mean, inv): each x tile is normalized on the SM before the product
reads it, and `ln_matmul_plan` sets how many 64-column weight boxes a
block takes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gill_tpu_torch.ops.geglu import H100_SMS, _aligned

SUPPORTED_DIMS = (320, 640)
MAX_STACK = 3
# (rows, weight boxes) a block, in the order the plan tries them
TILES = ((128, 2), (64, 2), (128, 1), (64, 1))


class LnMatmulPlan(NamedTuple):
    """The launch of `ln_matmul_wg` for x (m, d), ws (k, d, n): the k n / 64
    weight boxes of 64 columns (`boxes`), `nx` of them a block, in a grid
    of `col_blocks` x `row_blocks` blocks of `bm` rows."""
    bm: int
    nx: int
    boxes: int
    col_blocks: int
    row_blocks: int

    @property
    def blocks(self) -> int:
        return self.col_blocks * self.row_blocks


def ln_matmul_plan(m: int, d: int, n: int, k: int,
                   sms: int = H100_SMS) -> LnMatmulPlan:
    """The launch on a card with `sms` SMs: the first (bm, nx) of TILES
    that makes at least `sms` blocks, else (64, 1), the most blocks the
    call can have. Two boxes a block normalize each x tile once for both
    (with an odd box count the last block's second box repeats its first
    and is not stored), and 128 rows a block read each weight box half as
    often as 64; but a block's depth loop is a chain of d / 64 dependent
    steps (wait for the tile, normalize it, multiply), so an SM without a
    block costs more than either. At the UNet's shapes: K7 (128, 2) at
    (m, d) (8192, 320), 192 blocks, and (64, 2) at (2048, 640), 160; K8
    (128, 2), 512 and 240 blocks. A short m fills the card only with many
    boxes: at m 77 (two blocks of 64 rows) k 3 and n 320 give 30.
    csrc/ln_matmul.cu's `plan_for` must agree. Raises ValueError for d
    outside SUPPORTED_DIMS, n not a positive multiple of 64, k outside
    [1, MAX_STACK] or m < 1."""
    if d not in SUPPORTED_DIMS or n < 64 or n % 64 or not 1 <= k <= MAX_STACK \
            or m < 1:
        raise ValueError(f"ln_matmul kernel takes d in {SUPPORTED_DIMS}, n a "
                         f"multiple of 64, 1 <= k <= {MAX_STACK} and m >= 1; "
                         f"got m {m}, d {d}, n {n}, k {k}")
    boxes = k * n // 64
    for bm, nx in TILES:
        plan = LnMatmulPlan(bm, nx, boxes, -(-boxes // nx), -(-m // bm))
        if (nx == 1 or boxes > 1) and plan.blocks >= sms:
            break
    return plan


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
    if lib.gill_ln_matmul.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gill_ln_matmul.argtypes = [p] * 6 + [i] * 7 + [ctypes.c_float, p]
        lib.gill_ln_matmul.restype = i
        lib.gill_ln_matmul_plan.argtypes = [i] * 5 + [ctypes.POINTER(i)]
        lib.gill_ln_matmul_plan.restype = i
    return lib


def c_plan(m: int, d: int, n: int, k: int, sms: int = H100_SMS):
    """The `LnMatmulPlan` csrc/ln_matmul.cu makes for the call, or None
    where it refuses it (builds the library)."""
    out = (ctypes.c_int * 5)()
    if _lib().gill_ln_matmul_plan(m, d, n, k, sms, out):
        return None
    return LnMatmulPlan(*out)


def _run(lib, x2, gamma, beta, ws, eps: float, sms: int, stream, what: str):
    """x2 (m, d), m >= 1, ws (K, d, n) -> (K, m, n): allocates out and the
    float32 (m, 2) row statistics and launches `lib.gill_ln_matmul` at
    `ln_matmul_plan(m, d, n, K, sms)`."""
    from gill_tpu_torch.ops._build import check

    m, d = x2.shape
    kk, _, n = ws.shape
    plan = ln_matmul_plan(m, d, n, kk, sms)
    out = torch.empty((kk, m, n), device=x2.device, dtype=x2.dtype)
    stats = torch.empty((m, 2), device=x2.device, dtype=torch.float32)
    err = lib.gill_ln_matmul(
        *(t.data_ptr() for t in (x2, gamma, beta, ws, out, stats)),
        m, d, n, kk, plan.bm, plan.nx, sms, float(eps), stream)
    check(err, what)
    return out


def _launch(x, gamma, beta, ws, eps: float, what: str):
    """ws (K, d, n) -> (K, M, n) on the card: the checks, then the
    launches."""
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
    if not x2.shape[0]:
        return torch.empty((kk, 0, n), device=x.device, dtype=x.dtype)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return _run(_lib(), x2, gamma, beta, ws, eps, sms, stream, what)


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
