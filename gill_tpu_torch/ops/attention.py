"""Attention cores: the hand-written CUDA flash kernel + the plain path.

Counterpart of gill_tpu/ops/attention.py. Layouts: q (B, T, H, D), k/v
(B, S, H, D) -> out (B, T, H, D).

`dot_product_attention` keeps the JAX dispatcher's gates, with "the tensor
lies on a CUDA device" in place of `_on_tpu()`:
  * single-token causal decode with per-row lengths and the own token's
    k/v, over a bf16 cache in the kernel's scope on CUDA
    (`prefix_decode_eligible`) -> `prefix_decode_attention`
    (csrc/decode_attn.cu, reads only each row's valid prefix);
  * other single-token causal decode -> `_decode_attention` (mul + reduce
    over the cache, optional own-token `extra_kv`, scalar or per-row
    `kv_offset`, int8 caches through `kv_scales`);
  * multi-token queries with no bias / kv_offset and >= 256 keys on CUDA, or
    `impl="flash"` -> `flash_attention` (csrc/flash_attn.cu);
  * everything else -> `_xla_attention` (plain einsum + softmax).
gill_tpu gates its prefix-decode kernel behind GILL_PREFIX_DECODE_MIN
(default 0, off): on a TPU v5e the Pallas call serialised its cache DMA
against XLA's overlapped weight stream and lost end to end. That reason is
the TPU's scheduler, not the function, so the threshold is not ported: on
a GPU every kernel is its own launch anyway. The chunked valid-prefix
decode behind GILL_DECODE_CHUNK_MIN (default off) is not ported.

`flash_attention` launches the CUDA kernel for CUDA tensors and raises if it
cannot; a CPU tensor takes `flash_attention_ref`, its plain version.
`flash_attention_q8` (the UNet's `q8=True` mode, gill_tpu
`flash_attention_bthd(q8=True)`) does the same with csrc/flash_attn_i8.cu
and `flash_attention_q8_ref`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30    # gill_tpu's _NEG_INF


# ---------------------------------------------------------------------------
# plain paths
# ---------------------------------------------------------------------------

def _xla_attention(q, k, v, *, causal: bool, bias=None, scale: float,
                   kv_offset=None):
    """Einsum + softmax (gill_tpu `_xla_attention`): fp32 logits, causal
    mask aligned bottom-right (key j visible to query i when
    j <= i + offset, offset = S - T unless `kv_offset` is given), softmax
    in fp32, probabilities cast to q's dtype for the PV product."""
    t, s = q.shape[1], k.shape[1]
    logits = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        offset = (s - t) if kv_offset is None else kv_offset
        qi = torch.arange(t, device=q.device)[:, None]
        kj = torch.arange(s, device=q.device)[None, :]
        mask = kj <= qi + offset
        logits = torch.where(mask[None, None], logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _decode_attention(q, k, v, *, scale: float, kv_offset=None,
                      extra_kv=None, kv_scales=None):
    """Single-token (T == 1) attention as broadcast-multiply + reduce
    (gill_tpu `_decode_attention`). Valid keys are positions <= kv_offset
    (a scalar or a (B,) tensor of per-row positions; None = all of S).
    extra_kv: optional (k1, v1), each (B, 1, H, D) — the query's own
    key/value, attended jointly with the cache without concatenating.
    kv_scales: (ks, vs), each (B, S, H), for an int8 cache: the logits are
    multiplied by ks and the probabilities by vs, and the PV product runs
    in bf16."""
    s = k.shape[1]
    qf = q[:, 0].float()                                      # (B, H, D)
    logits = (qf[:, None] * k.float()).sum(-1)                # (B, S, H)
    vdt = torch.bfloat16 if v.dtype == torch.int8 else v.dtype
    if kv_scales is not None:
        ks, vs = kv_scales
        logits = logits * ks.float()
    logits = logits * scale
    if kv_offset is not None:
        off = torch.as_tensor(kv_offset, device=q.device)
        if off.ndim == 1:
            off = off[:, None, None]
        pos = torch.arange(s, device=q.device)[None, :, None]
        logits = torch.where(pos <= off, logits,
                             torch.full_like(logits, NEG_INF))
    if extra_kv is not None:
        k1, v1 = extra_kv
        l1 = (qf * k1[:, 0].float()).sum(-1) * scale           # (B, H)
        m = torch.maximum(logits.amax(dim=1, keepdim=True), l1[:, None])
        p = torch.exp(logits - m)                              # (B, S, H)
        p1 = torch.exp(l1[:, None] - m)                        # (B, 1, H)
        denom = p.sum(dim=1, keepdim=True) + p1
        pfac = p / denom
        if kv_scales is not None:
            pfac = pfac * vs.float()
        acc = (pfac[..., None].to(vdt) * v.to(vdt)).sum(dim=1)
        acc = acc + (p1 / denom)[:, 0, :, None].to(vdt) * v1[:, 0].to(vdt)
        return acc[:, None]
    m = logits.amax(dim=1, keepdim=True)
    p = torch.exp(logits - m)
    p = p / p.sum(dim=1, keepdim=True)
    if kv_scales is not None:
        p = p * vs.float()
    return (p[..., None].to(vdt) * v.to(vdt)).sum(dim=1)[:, None]


def flash_attention_ref(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None,
                        kv_len: Optional[int] = None):
    """Plain version of the flash kernel, same arithmetic in one pass:
    fp32 logits from the input-dtype operands, keys at or beyond `kv_len`
    masked, causal bottom-right, exact softmax statistics in fp32, the
    probabilities rounded to v's dtype before the PV product (as the
    kernel and the Pallas original feed it) and divided by the fp32 sum."""
    t, s, d = q.shape[1], k.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    kv_len = s if kv_len is None else kv_len
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    kj = torch.arange(s, device=q.device)[None, :]
    ok = kj < kv_len
    if causal:
        qi = torch.arange(t, device=q.device)[:, None]
        ok = ok & (kj <= qi + (s - t))
    logits = torch.where(ok[None, None], logits,
                         torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), v.float())
    return (o / denom.clamp_min(1e-30).permute(0, 2, 1, 3)).to(q.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel (csrc/flash_attn.cu)
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 512


def _flash_lib():
    from gill_tpu_torch.ops import _build

    lib = _build.load("flash_attn")
    fn = lib.gill_flash_attn
    if fn.argtypes is None:
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [i, p, p, p, p, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ll, ll, ll,
                       ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None, fast: bool = False):
    """Flash attention, q (B,T,H,D), k/v (B,S,H,D) -> contiguous (B,T,H,D).

    Replaces gill_tpu `flash_attention` and `flash_attention_bthd`: strided
    inputs at the true head dim (no lane padding, no transposes); `scale`
    defaults to 1/sqrt(D); keys at or beyond `kv_len` are masked. `fast`
    (the Pallas clamp-shift softmax) is accepted and computed exactly.
    CUDA tensors launch the kernel (fp32 or bf16, D <= 512) or raise; CPU
    tensors take `flash_attention_ref`."""
    del fast
    b, t, h, d = q.shape
    s = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    kv_len = s if kv_len is None else int(kv_len)
    if not 0 < kv_len <= s:
        raise ValueError(f"kv_len {kv_len} outside (0, {s}]")
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   kv_len=kv_len)
    if k.shape != (b, s, h, d) or v.shape != (b, s, h, d):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes fp32 or bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must share one device")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty((b, t, h, d), device=q.device, dtype=q.dtype)
    fn = _flash_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), b, t, s, h, d,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             scale, int(causal), kv_len, stream)
    from gill_tpu_torch.ops._build import check

    check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# int8-QK flash attention (csrc/flash_attn_i8.cu)
# ---------------------------------------------------------------------------

def _int8_sym(x, dims):
    """Symmetric int8 of x over `dims` (gill_tpu `_flash_kernel_i8`):
    scale max(amax/127, 1e-12) kept with those dims, values
    clip(round(x / scale), +-127) as fp32 integers, and the scale."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=dims, keepdim=True) / 127.0,
                        min=1e-12)
    return torch.clamp(torch.round(xf / scale), -127, 127), scale


def flash_attention_q8_ref(q, k, v, *, scale: float, q_block: int = 1024):
    """Plain version of the int8-QK kernel, q (B,T,H,D), k/v (B,S,H,D):
    k quantized per (b, h), q per (b, h, group of q_block rows) (the last
    group may be partial, its absent rows count as zeros); exact int32
    scores (products of values <= 127 over D <= 128 stay integers below
    2^24, so the float64 product is exact) times (sq * sk) * scale in fp32;
    exact softmax in fp32; p rounded to v's dtype for the PV product with
    fp32 sums, divided by the fp32 sum and rounded once to q's dtype."""
    b, t, h, d = q.shape
    ng = -(-t // q_block)
    kq, sk = _int8_sym(k, (1, 3))                       # sk (B, 1, H, 1)
    qg = torch.nn.functional.pad(q.float(), (0, 0, 0, 0, 0, ng * q_block - t))
    qq, sq = _int8_sym(qg.reshape(b, ng, q_block, h, d), (2, 4))
    qq = qq.reshape(b, ng * q_block, h, d)[:, :t]
    sq = sq.expand(b, ng, q_block, h, 1).reshape(b, ng * q_block, h)[:, :t]
    s32 = torch.einsum("bthd,bshd->bhts", qq.double(), kq.double()).float()
    c = (sq * sk[:, 0, :, 0][:, None]) * scale          # (B, T, H)
    logits = s32 * c.permute(0, 2, 1)[..., None]
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), v.float())
    return (o / denom.clamp_min(1e-30).permute(0, 2, 1, 3)).to(q.dtype)


def _q8_lib():
    from gill_tpu_torch.ops import _build

    lib = _build.load("flash_attn_i8")
    if lib.gill_flash_attn_q8.argtypes is None:
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.gill_flash_attn_q8.argtypes = [p] * 8 + [i] * 6 + [ll] * 9 + [
            ctypes.c_float, p]
        lib.gill_flash_attn_q8.restype = i
        lib.gill_flash_attn_q8_dp.argtypes = [i]
        lib.gill_flash_attn_q8_dp.restype = i
    return lib


Q8_MAX_HEAD_DIM = 128


def flash_attention_q8(q, k, v, *, scale: float, q_block: int = 1024):
    """Int8-QK attention, q (B,T,H,D), k/v (B,S,H,D) -> contiguous
    (B,T,H,D), non-causal. Replaces gill_tpu `flash_attention_bthd(q8=
    True)` (Pallas `_flash_kernel_i8`): q and k quantized dynamically
    (q_block = gill_tpu's block_q, 1024 at every UNet shape), int8 QK with
    int32 sums, exact softmax, bf16 PV. CUDA tensors launch the kernel
    (bf16, D <= 128, strided views taken as they are) or raise; CPU
    tensors take `flash_attention_q8_ref`."""
    b, t, h, d = q.shape
    s = k.shape[1]
    if not q.is_cuda:
        return flash_attention_q8_ref(q, k, v, scale=scale, q_block=q_block)
    if k.shape != (b, s, h, d) or v.shape != (b, s, h, d):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise TypeError(f"flash_attention_q8 takes bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not 0 < d <= Q8_MAX_HEAD_DIM or q_block <= 0 or t == 0 or s == 0:
        raise ValueError(f"flash_attention_q8: head dim {d} (at most "
                         f"{Q8_MAX_HEAD_DIM}), q_block {q_block}, T {t}, S {s}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must share one device")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    lib = _q8_lib()
    dp = lib.gill_flash_attn_q8_dp(d)
    dev = q.device
    out = torch.empty((b, t, h, d), device=dev, dtype=q.dtype)
    qq = torch.empty((b * h, t, dp), device=dev, dtype=torch.int8)
    kq = torch.empty((b * h, s, dp), device=dev, dtype=torch.int8)
    sq = torch.empty((b * h, -(-t // q_block)), device=dev,
                     dtype=torch.float32)
    sk = torch.empty((b * h,), device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.gill_flash_attn_q8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        qq.data_ptr(), kq.data_ptr(), sq.data_ptr(), sk.data_ptr(),
        b, t, s, h, d, q_block,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), float(scale), stream)
    from gill_tpu_torch.ops._build import check

    check(err, "flash_attention_q8")
    flash_attention_q8.launches += 1
    return out


flash_attention_q8.launches = 0


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

def flash_eligible(*, on_cuda: bool, t: int, s: int, has_bias: bool,
                   has_kv_offset: bool, impl: str) -> bool:
    """The dispatcher's flash gate: forced by impl='flash'; under 'auto',
    multi-token queries over >= 256 keys with no additive bias or dynamic
    kv_offset, on a CUDA device (gill_tpu: on a TPU)."""
    return impl == "flash" or (
        impl == "auto" and on_cuda and not has_bias and not has_kv_offset
        and t > 1 and s >= 256)


def prefix_decode_eligible(q, k, kv_offset, extra_kv, kv_scales, *,
                           on_cuda: bool) -> bool:
    """The dispatcher's gate for the valid-prefix decode kernel: per-row
    offsets and the own token's k/v given, the kernel's scope
    (`decode_attn.supported`), on a CUDA device. gill_tpu's measured-on-TPU
    minimum bucket (PREFIX_DECODE_MIN) is not ported (module docstring)."""
    from gill_tpu_torch.ops import decode_attn

    return (on_cuda and kv_offset is not None and extra_kv is not None
            and decode_attn.supported(q, k, kv_offset, kv_scales))


def dot_product_attention(q, k, v, *, causal: bool = False, bias=None,
                          kv_offset=None, impl: str = "auto",
                          fast: bool = False, extra_kv=None, kv_scales=None,
                          kv_lengths=None):
    """Attention core (gill_tpu `dot_product_attention`, same gates).

    impl: 'auto' | 'xla' | 'flash'. Single-token causal decode takes the
    valid-prefix kernel where `prefix_decode_eligible`, else the mul +
    reduce path; `flash_eligible` calls take the flash kernel; everything
    else the plain einsum path. `kv_lengths`: the (B,) int32 valid cache
    rows kv_offset + 1 where the caller has made them already (opt.forward
    makes them once a forward, not once a layer)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if q.shape[1] == 1 and causal and bias is None and impl != "xla":
        if prefix_decode_eligible(q, k, kv_offset, extra_kv, kv_scales,
                                  on_cuda=q.is_cuda):
            from gill_tpu_torch.ops import decode_attn

            lens = kv_lengths if kv_lengths is not None else \
                torch.broadcast_to(torch.as_tensor(kv_offset, device=q.device)
                                   + 1, (q.shape[0],))
            return decode_attn.prefix_decode_attention(
                q, k, v, lens, extra_kv[0], extra_kv[1], scale=scale)
        off = k.shape[1] - 1 if kv_offset is None else kv_offset
        return _decode_attention(q, k, v, scale=scale, kv_offset=off,
                                 extra_kv=extra_kv,
                                 kv_scales=kv_scales).to(q.dtype)
    if extra_kv is not None or kv_scales is not None:
        raise ValueError("extra_kv/kv_scales are decode-only")
    if flash_eligible(on_cuda=q.is_cuda, t=q.shape[1], s=k.shape[1],
                      has_bias=bias is not None,
                      has_kv_offset=kv_offset is not None, impl=impl):
        return flash_attention(q, k, v, causal=causal, scale=scale, fast=fast)
    return _xla_attention(q, k, v, causal=causal, bias=bias, scale=scale,
                          kv_offset=kv_offset)
