"""Fused GEGLU feed-forward: the hand-written CUDA kernel + its plain version.

Counterpart of gill_tpu/ops/geglu.py. Computes
    out = (gelu(x @ Wg + bg) * (x @ Wv + bv)) @ W2 + b2
with w1 (d, 8d) packing the [val | gate] halves, w2 (4d, d) and the exact
erf gelu of diffusers' GEGLU. CUDA tensors launch csrc/geglu.cu (bf16,
d in {320, 640, 1280}: the SD v1.5 UNet widths) or raise; CPU tensors take
`geglu_ff_ref`, the composed path of gill_tpu's `unet._geglu_ff`. The
launches follow `geglu_plan`: two tensor-core GEMMs, the first writing the
gated (M, 4d) intermediate in bf16, the second's depth split where its
tiles cannot fill the card.

With `ln_gamma`/`ln_beta` (GILL_SD_FUSE_LN=1) x is the raw residual stream
and the block's third LayerNorm is folded in, as gill_tpu's Pallas
`_kernel_ln` folds it (K9): a pre-pass writes each row's (mean, inv), and
the first GEMM normalizes each x tile on the SM with `ln_matmul.ln_rows`'
rounding points before its tensor cores read it, so the normalized tensor
never exists in device memory; the launches follow the same `geglu_plan`.
The kernel's gelu stays the exact erf form, where `_kernel_ln` takes the
tanh form only because Mosaic lacks erf.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

SUPPORTED_DIMS = (320, 640, 1280)
H100_SMS = 132
DEPTH_TILE = 64          # the depth of K3's staged tiles


class GegluPlan(NamedTuple):
    """K3's launches for x (m, d), and K9's after its row statistics, 128
    rows a block: `geglu_up_wg` at 64 columns of h a block (`up_blocks`
    blocks), then `geglu_down_wg` at `down_bn` columns (`down_tiles` output
    tiles), its depth split `splits` ways (a float32 (splits, m, d)
    workspace and a fixed-order sum when above 1)."""
    up_blocks: int
    down_bn: int
    down_tiles: int
    splits: int


def _check_dim(d: int) -> None:
    if d not in SUPPORTED_DIMS:
        raise ValueError(f"geglu_ff kernel takes d in {SUPPORTED_DIMS}, "
                         f"got {d}")


def geglu_plan(m: int, d: int, sms: int = H100_SMS) -> GegluPlan:
    """K3's plan on a card with `sms` SMs: `geglu_down_wg` takes 128
    output columns a block where d allows (64 at d 320) and, when its tiles
    are fewer than half the SMs, splits its depth into ceil(sms / tiles)
    parts of at least four 64-deep steps (4 at d 1280 M 512, 14 at M 128;
    a split at d 640 M 2048's 80 tiles measured slower on the H100).
    Raises ValueError for d outside SUPPORTED_DIMS or m < 1."""
    _check_dim(d)
    if m < 1:
        raise ValueError(f"geglu_plan takes m >= 1, got {m}")
    rows = -(-m // 128)
    down_bn = 128 if d % 128 == 0 else 64
    tiles = rows * (d // down_bn)
    splits = 1
    if 2 * tiles < sms:
        splits = min(-(-sms // tiles), 4 * d // DEPTH_TILE // 4)
    return GegluPlan(rows * (4 * d // 64), down_bn, tiles, splits)


def geglu_ff_ref(x, w1, b1, w2, b2, *, ln_gamma=None, ln_beta=None,
                 ln_eps: float = 1e-5):
    """Composed GEGLU FF in x's dtype (gill_tpu `unet._geglu_ff` off-TPU):
    the fused projection, split into [val | gate], val * erf-gelu(gate),
    then the output projection; with ln_gamma, `ln_rows` first."""
    if ln_gamma is not None:
        from gill_tpu_torch.ops.ln_matmul import ln_rows

        x = ln_rows(x, ln_gamma, ln_beta, ln_eps)
    h = x @ w1.to(x.dtype) + b1.to(x.dtype)
    val, gate = h.chunk(2, dim=-1)
    return (val * F.gelu(gate)) @ w2.to(x.dtype) + b2.to(x.dtype)


def _geglu_lib():
    from gill_tpu_torch.ops import _build

    lib = _build.load("geglu")
    if lib.gill_geglu_ff.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gill_geglu_ff.argtypes = [p] * 11 + [ctypes.c_float] + [i] * 4 \
            + [p]
        lib.gill_geglu_ff.restype = i
    return lib


def _aligned(t):
    """Contiguous, with a 16-byte aligned base (the kernel's vector loads)."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(lib, x2, w1, b1, w2, b2, ln, ln_eps: float, sms: int, stream):
    """K3 (ln None) or K9 (ln = (gamma, beta)) on x2 (m, d), m >= 1, at
    `geglu_plan(m, d, sms)`: allocates out, the (m, 4d) intermediate, a
    split's float32 workspace and K9's float32 (m, 2) row statistics, and
    launches through `lib.gill_geglu_ff`. Returns out."""
    from gill_tpu_torch.ops._build import check

    m, d = x2.shape
    plan = geglu_plan(m, d, sms)
    out = torch.empty_like(x2)
    h = torch.empty((m, 4 * d), device=x2.device, dtype=torch.bfloat16)
    f32 = dict(device=x2.device, dtype=torch.float32)
    ws = torch.empty((plan.splits, m, d), **f32) if plan.splits > 1 else None
    gamma, beta = ln if ln is not None else (None, None)
    stats = None if ln is None else torch.empty((m, 2), **f32)
    err = lib.gill_geglu_ff(
        *(_ptr(t) for t in (x2, w1, b1, w2, b2, h, out, ws, gamma, beta,
                            stats)),
        float(ln_eps), m, d, plan.down_bn, plan.splits, stream)
    check(err, "geglu_ff" if ln is None else "geglu_ff(ln)")
    return out


def geglu_ff(x, w1, b1, w2, b2, *, ln_gamma=None, ln_beta=None,
             ln_eps: float = 1e-5):
    """x (..., d) -> (..., d). Replaces gill_tpu `geglu_ff` (Pallas
    `_kernel`: K3, the two GEMMs of `geglu_plan`) and, with
    ln_gamma/ln_beta, `_kernel_ln` (K9: the row statistics, then the same
    GEMMs with the LayerNorm applied to each x tile on the SM). Each counts
    one launch a call on its own attribute (`geglu_ff.launches`,
    `geglu_ff.ln_launches`)."""
    if not x.is_cuda:
        return geglu_ff_ref(x, w1, b1, w2, b2, ln_gamma=ln_gamma,
                            ln_beta=ln_beta, ln_eps=ln_eps)
    d = x.shape[-1]
    fold_ln = ln_gamma is not None
    _check_dim(d)
    shapes = {"w1": (w1, (d, 8 * d)), "b1": (b1, (8 * d,)),
              "w2": (w2, (4 * d, d)), "b2": (b2, (d,))}
    if fold_ln:
        shapes.update({"ln_gamma": (ln_gamma, (d,)), "ln_beta": (ln_beta, (d,))})
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
    tensors = (x, w1, b1, w2, b2) + ((ln_gamma, ln_beta) if fold_ln else ())
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError("geglu_ff kernel takes bf16 tensors")
    if any(t.device != x.device for t in tensors):
        raise ValueError("geglu_ff tensors must share one device")
    x2, w1, b1, w2, b2 = (_aligned(t) for t in (x.reshape(-1, d), w1, b1,
                                                 w2, b2))
    if not x2.shape[0]:
        return torch.empty_like(x)
    ln = (_aligned(ln_gamma), _aligned(ln_beta)) if fold_ln else None
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = _launch(_geglu_lib(), x2, w1, b1, w2, b2, ln, ln_eps, sms, stream)
    if fold_ln:
        geglu_ff.ln_launches += 1
    else:
        geglu_ff.launches += 1
    return out.reshape(x.shape)


geglu_ff.launches = 0
geglu_ff.ln_launches = 0
