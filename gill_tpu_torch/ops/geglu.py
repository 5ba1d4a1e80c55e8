"""Fused GEGLU feed-forward: the hand-written CUDA kernel + its plain version.

Counterpart of gill_tpu/ops/geglu.py. Computes
    out = (gelu(x @ Wg + bg) * (x @ Wv + bv)) @ W2 + b2
with w1 (d, 8d) packing the [val | gate] halves, w2 (4d, d) and the exact
erf gelu of diffusers' GEGLU. CUDA tensors launch csrc/geglu.cu (bf16,
d in {320, 640, 1280}: the SD v1.5 UNet widths) or raise; CPU tensors take
`geglu_ff_ref`, the composed path of gill_tpu's `unet._geglu_ff`.

With `ln_gamma`/`ln_beta` (GILL_SD_FUSE_LN=1) x is the raw residual stream
and the block's third LayerNorm is folded in, as gill_tpu's Pallas
`_kernel_ln` folds it: the same kernel normalizes its resident x tile with
`ln_matmul.ln_rows`' rounding points before the first product, so the
normalized tensor never exists in device memory. The kernel's gelu stays
the exact erf form, where `_kernel_ln` takes the tanh form only because
Mosaic lacks erf.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

SUPPORTED_DIMS = (320, 640, 1280)


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
        lib.gill_geglu_ff.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
        lib.gill_geglu_ff.restype = i
        lib.gill_geglu_ff_splits.argtypes = [i, i, i]
        lib.gill_geglu_ff_splits.restype = i
        lib.gill_geglu_ff_ln.argtypes = [p, p, p, ctypes.c_float,
                                         p, p, p, p, p, p, i, i, i, p]
        lib.gill_geglu_ff_ln.restype = i
    return lib


def _aligned(t):
    """Contiguous, with a 16-byte aligned base (the kernel's vector loads)."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def geglu_ff(x, w1, b1, w2, b2, *, ln_gamma=None, ln_beta=None,
             ln_eps: float = 1e-5):
    """x (..., d) -> (..., d). Replaces gill_tpu `geglu_ff` (Pallas
    `_kernel`, and `_kernel_ln` with ln_gamma/ln_beta): both products and
    the gating in one kernel, the (M, 4d) intermediate never leaves the
    SM. Each form counts its own launches (`geglu_ff.launches`,
    `geglu_ff.ln_launches`)."""
    if not x.is_cuda:
        return geglu_ff_ref(x, w1, b1, w2, b2, ln_gamma=ln_gamma,
                            ln_beta=ln_beta, ln_eps=ln_eps)
    d = x.shape[-1]
    fold_ln = ln_gamma is not None
    if d not in SUPPORTED_DIMS:
        raise ValueError(f"geglu_ff kernel takes d in {SUPPORTED_DIMS}, got {d}")
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
    m = x2.shape[0]
    out = torch.empty_like(x2)
    if m:
        lib = _geglu_lib()
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits = lib.gill_geglu_ff_splits(m, d, sms)
        ws = (torch.empty((splits, m, d), device=x.device, dtype=torch.float32)
              if splits > 1 else None)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                out.data_ptr(), None if ws is None else ws.data_ptr(),
                m, d, splits, stream)
        from gill_tpu_torch.ops._build import check

        if fold_ln:
            g, b = _aligned(ln_gamma), _aligned(ln_beta)
            err = lib.gill_geglu_ff_ln(x2.data_ptr(), g.data_ptr(),
                                       b.data_ptr(), float(ln_eps), *args)
            check(err, "geglu_ff(ln)")
            geglu_ff.ln_launches += 1
        else:
            err = lib.gill_geglu_ff(x2.data_ptr(), *args)
            check(err, "geglu_ff")
            geglu_ff.launches += 1
    return out.reshape(x.shape)


geglu_ff.launches = 0
geglu_ff.ln_launches = 0
