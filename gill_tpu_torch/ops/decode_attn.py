"""Valid-prefix single-token decode attention: the hand-written CUDA
kernel + its plain version.

Counterpart of gill_tpu/ops/decode_attn.py. For q/k1/v1 (B, 1, H, D) and a
cache k/v (B, S, H, D), each batch row b attends over its first
`lengths[b]` cache rows plus its own (k1, v1) jointly, with an exact fp32
softmax; `lengths` are clipped to [0, S] and 0 gives v1. The output is in
q's dtype. The serving engines pass a strided view of their KV pool (one
layer, one read window): the kernel reads it in place.

CUDA tensors launch csrc/decode_attn.cu (bf16 cache, D a multiple of 128)
or raise; CPU tensors take `prefix_decode_attention_ref`.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30    # gill_tpu's _NEG_INF
_HEAD_DIMS = (128, 256, 512)


def _pick_block(s: int) -> int:
    for cand in (256, 128, 64):
        if s % cand == 0:
            return cand
    return 0


def supported(q, k, lengths, kv_scales) -> bool:
    """The kernel's scope (gill_tpu `decode_attn.supported`): one query
    token, per-row lengths, no int8 scales, a bucket divisible by 256, 128
    or 64, D % 128 == 0 — and, here, a bf16 cache (gill_tpu admits any
    cache that is not int8; fp32 caches take the plain decode path)."""
    _, t, _, d = q.shape
    return (t == 1 and kv_scales is None and _pick_block(k.shape[1]) > 0
            and k.dtype == torch.bfloat16 and lengths is not None
            and d % 128 == 0)


def prefix_decode_attention_ref(q, k, v, lengths, k1, v1, *, scale: float):
    """Plain version with the kernel's arithmetic: k1/v1 cast to the cache
    dtype, fp32 logits and softmax over each row's valid prefix plus its
    own token, fp32 products with v, one rounding to q's dtype."""
    s = k.shape[1]
    lens = lengths.long().clamp(0, s)
    qf = q[:, 0].float()                                        # (B, H, D)
    k1 = k1.to(k.dtype)[:, 0].float()
    v1 = v1.to(v.dtype)[:, 0].float()
    logits = torch.einsum("bhd,bshd->bsh", qf, k.float()) * scale
    pos = torch.arange(s, device=q.device)[None, :, None]
    logits = torch.where(pos < lens[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    l1 = (qf * k1).sum(-1) * scale                              # (B, H)
    m = torch.maximum(logits.amax(dim=1), l1)
    p = torch.exp(logits - m[:, None])
    p1 = torch.exp(l1 - m)
    denom = p.sum(dim=1) + p1
    acc = torch.einsum("bsh,bshd->bhd", p, v.float()) + p1[..., None] * v1
    out = acc / denom.clamp_min(1e-30)[..., None]
    return out[:, None].to(q.dtype)


def _lib():
    from gill_tpu_torch.ops import _build

    lib = _build.load("decode_attn")
    fn = lib.gill_prefix_decode_attn
    if fn.argtypes is None:
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ctypes.c_float, p]
        fn.restype = i
    return fn


def _row_major(t):
    return t if t.is_contiguous() and t.data_ptr() % 16 == 0 else \
        t.clone(memory_format=torch.contiguous_format)


def prefix_decode_attention(q, k, v, lengths, k1, v1, *, scale: float):
    """q/k1/v1 (B, 1, H, D); cache k/v (B, S, H, D), any strides with a
    unit last one; lengths (B,) = valid cache rows per batch row. Returns
    (B, 1, H, D) in q.dtype. Replaces gill_tpu `prefix_decode_attention`
    (Pallas `_kernel`)."""
    if not q.is_cuda:
        return prefix_decode_attention_ref(q, k, v, lengths, k1, v1,
                                           scale=scale)
    b, t, h, d = q.shape
    s = k.shape[1]
    if t != 1 or k.shape != (b, s, h, d) or v.shape != (b, s, h, d) \
            or k1.shape != (b, 1, h, d) or v1.shape != (b, 1, h, d) \
            or tuple(lengths.shape) != (b,):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} k1 {tuple(k1.shape)} v1 "
                         f"{tuple(v1.shape)} lengths {tuple(lengths.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"prefix_decode_attention kernel takes D in "
                         f"{_HEAD_DIMS}, got {d}")
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16 \
            or q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"prefix_decode_attention kernel takes a bf16 cache "
                        f"and a bf16 or fp32 q, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    tensors = (k, v, lengths, k1, v1)
    if any(x.device != q.device for x in tensors):
        raise ValueError("prefix_decode_attention tensors must share one "
                         "device")
    for name, c in (("k", k), ("v", v)):
        if c.stride(3) != 1 or any(st % 8 for st in c.stride()[:3]) \
                or c.data_ptr() % 16:
            raise ValueError(f"cache {name} needs a unit last stride, other "
                             f"strides multiples of 8 and a 16-byte aligned "
                             f"base; got strides {c.stride()}")
    q, k1, v1 = _row_major(q), _row_major(k1.to(k.dtype)), \
        _row_major(v1.to(v.dtype))
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k1.data_ptr(), v1.data_ptr(), k.data_ptr(),
                 v.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 int(q.dtype == torch.float32), b, s, h, d,
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2), float(scale),
                 torch.cuda.current_stream(q.device).cuda_stream)
    from gill_tpu_torch.ops._build import check

    check(err, "prefix_decode_attention")
    prefix_decode_attention.launches += 1
    return out


prefix_decode_attention.launches = 0
