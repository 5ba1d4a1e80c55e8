"""Valid-prefix single-token decode attention: the hand-written CUDA
kernel + its plain version.

Counterpart of gill_tpu/ops/decode_attn.py. For q/k1/v1 (B, 1, H, D) and a
cache k/v (B, S, H, D), each batch row b attends over its first
`lengths[b]` cache rows plus its own (k1, v1) jointly, with an exact fp32
softmax; `lengths` are clipped to [0, S] and 0 gives v1. The output is in
q's dtype. The serving engines pass a strided view of their KV pool (one
layer, one read window): the kernel reads it in place.

CUDA tensors launch csrc/decode_attn.cu (bf16 cache, D in {128, 256,
512}) in one launch at the geometry `decode_plan` gives for the rows of the
pool the view reads (`plan_rows`), or raise; CPU
tensors take `prefix_decode_attention_ref`. The kernel splits each row's
cache along S over the blocks of a thread-block cluster and merges the
splits in rank order; `prefix_decode_attention_split_ref` is that
arithmetic in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

NEG_INF = -1e30    # gill_tpu's _NEG_INF
_HEAD_DIMS = (128, 256, 512)
H100_SMS = 132
MAX_SPLITS = 8        # the portable thread-block cluster size
MIN_ROWS = 128        # fewest cache rows a split takes
BLOCKS_PER_SM = 2     # blocks an SM holds: a 96 KB ring, 256 threads
ROW_ELEMS = 512       # a block's row slice, heads x D, at most
STAGE_BYTES = 32768   # k and v of one ring stage


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


class DecodePlan(NamedTuple):
    """K6's launch for (B, S, H, D): each block reads `heads` heads (a
    contiguous heads x D slice of every cache row) over `rows` cache rows;
    split j of a batch row covers rows [j rows, (j + 1) rows) of its valid
    prefix; the `splits` blocks of one (batch row, head group) form a
    thread-block cluster and merge in rank order; `tile_rows` rows a ring
    stage; `blocks` blocks of 256 threads; one launch a call."""
    heads: int
    splits: int
    rows: int
    tile_rows: int
    blocks: int


def split_rows(s: int, splits: int) -> int:
    """Cache rows a split covers when a bucket of `s` rows is cut into
    `splits`: ceil(s / splits) rounded up to a multiple of 8 (so the last
    splits may be empty for small s; ceil(s / rows) of them hold rows)."""
    return -(-(-(-s // splits)) // 8) * 8


@functools.lru_cache(maxsize=1024)
def decode_plan(b: int, s: int, h: int, d: int,
                num_sms: int = H100_SMS) -> DecodePlan:
    """The geometry csrc/decode_attn.cu's `plan_for` gives (the C side
    refuses any other). It reads the bucket S, B, H, D and the SM count,
    never `lengths`. Heads a block: 512 // D, halved until it divides H and
    until the head groups with the most splits fill at least half of the
    card's 2 resident blocks an SM (one wave). Splits:
    as many as fill it, at most 8 (the portable cluster) and at most
    ceil(S / 128); rows a split `split_rows(S, splits)`, and the splits that
    leaves. Raises ValueError for a call the kernel does not take."""
    if d not in _HEAD_DIMS or min(b, s, h, num_sms) < 1 or b > 65535:
        raise ValueError(f"prefix_decode_attention kernel takes D in "
                         f"{_HEAD_DIMS} and positive B <= 65535, S, H; got "
                         f"B={b} S={s} H={h} D={d}")
    hg = ROW_ELEMS // d
    while h % hg:
        hg //= 2
    # the resident blocks: a plan past one wave waits for a second
    cap = num_sms * BLOCKS_PER_SM
    while hg > 1 and 2 * b * (h // hg) * MAX_SPLITS < cap:
        hg //= 2
    if h // hg > 65535:
        raise ValueError(f"prefix_decode_attention kernel takes at most "
                         f"65535 head groups, got H={h}")
    pairs = b * (h // hg)
    sp = max(1, min(cap // pairs, MAX_SPLITS, -(-s // MIN_ROWS)))
    rows = split_rows(s, sp)
    splits = -(-s // rows)
    return DecodePlan(hg, splits, rows, STAGE_BYTES // 4 // (hg * d),
                      pairs * splits)


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


def prefix_decode_attention_split_ref(q, k, v, lengths, k1, v1, *,
                                      scale: float, splits: int):
    """Plain version of the kernel's split arithmetic: the cache rows cut
    into splits of `split_rows(S, splits)` rows; per split an fp32 partial
    (m, l, acc) over its valid rows (m = -1e30, l = 0, acc = 0 where it
    has none); the partials merged in split order; then the own token
    folded in; one rounding to q's dtype. The CPU tests hold it against
    gill_tpu's kernel; nothing on the card's path calls it."""
    s = k.shape[1]
    rows = split_rows(s, splits)
    lens = lengths.long().clamp(0, s)
    qf = q[:, 0].float()                                        # (B, H, D)
    k1 = k1.to(k.dtype)[:, 0].float()
    v1 = v1.to(v.dtype)[:, 0].float()
    parts = []
    for r0 in range(0, s, rows):
        kj, vj = k[:, r0:r0 + rows].float(), v[:, r0:r0 + rows].float()
        lj = torch.einsum("bhd,bshd->bsh", qf, kj) * scale
        pos = torch.arange(r0, r0 + kj.shape[1], device=q.device)
        valid = (pos[None, :] < lens[:, None])[..., None]      # (B, r, 1)
        lj = torch.where(valid, lj, torch.full_like(lj, NEG_INF))
        mj = lj.amax(dim=1)                                     # (B, H)
        pj = torch.where(valid, torch.exp(lj - mj[:, None]),
                         torch.zeros_like(lj))
        parts.append((mj, pj.sum(dim=1),
                      torch.einsum("bsh,bshd->bhd", pj, vj)))
    mt = torch.stack([mj for mj, _, _ in parts]).amax(dim=0)
    lt = torch.zeros_like(mt)
    at = torch.zeros_like(qf)
    for mj, lj, aj in parts:                                    # split order
        w = torch.exp(mj - mt)
        lt = lt + lj * w
        at = at + aj * w[..., None]
    l1 = (qf * k1).sum(-1) * scale                              # (B, H)
    m_new = torch.maximum(mt, l1)
    alpha, p1 = torch.exp(mt - m_new), torch.exp(l1 - m_new)
    out = (at * alpha[..., None] + p1[..., None] * v1) \
        / (lt * alpha + p1).clamp_min(1e-30)[..., None]
    return out[:, None].to(q.dtype)


def _lib():
    from gill_tpu_torch.ops import _build

    lib = _build.load("decode_attn")
    fn = lib.gill_prefix_decode_attn
    if fn.argtypes is None:
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ctypes.c_float, i, i, i, i, p]
        fn.restype = i
        lib.gill_decode_plan.argtypes = [i] * 5 + [ctypes.POINTER(ctypes.c_int)]
        lib.gill_decode_plan.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def c_plan(b: int, s: int, h: int, d: int, num_sms: int):
    """(heads, splits, rows, tile_rows, blocks) as the C side plans them,
    or None where it refuses the call (builds the library)."""
    out = (ctypes.c_int * 5)()
    err = _lib().gill_decode_plan(b, s, h, d, num_sms, out)
    return None if err else tuple(out)


def plan_rows(k, v) -> int:
    """The cache rows K6 plans its splits for: those of the pool a
    (B, S, H, D) view reads (its batch stride over its row stride, where
    both k and v are such windows), else the view's S. The engines decode
    over a read window that the other slots' depths set; planned for the
    pool, a row keeps its splits, and so its bits, whatever the window."""
    s = k.shape[1]
    pools = [c.stride(0) // c.stride(1) if c.stride(1) > 0 and
             c.stride(0) % c.stride(1) == 0 else 0 for c in (k, v)]
    return max(s, min(pools))


def _row_major(t):
    return t if t.is_contiguous() and t.data_ptr() % 16 == 0 else \
        t.clone(memory_format=torch.contiguous_format)


def prefix_decode_attention(q, k, v, lengths, k1, v1, *, scale: float):
    """q/k1/v1 (B, 1, H, D); cache k/v (B, S, H, D), any strides with a
    unit last one; lengths (B,) = valid cache rows per batch row. Returns
    (B, 1, H, D) in q.dtype. Replaces gill_tpu `prefix_decode_attention`
    (Pallas `_kernel`); on the card, one launch at `decode_plan` for the
    pool's rows (`plan_rows`)."""
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
    sms = _num_sms(q.device.index or 0)
    s_plan = plan_rows(k, v)
    plan = decode_plan(b, s_plan, h, d, sms)
    q, k1, v1 = _row_major(q), _row_major(k1.to(k.dtype)), \
        _row_major(v1.to(v.dtype))
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    err = _lib().gill_prefix_decode_attn(
        q.data_ptr(), k1.data_ptr(), v1.data_ptr(), k.data_ptr(),
        v.data_ptr(), lens.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.float32), b, s, s_plan, h, d,
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), float(scale), sms,
        plan.heads, plan.splits, plan.rows,
        torch.cuda.current_stream(q.device).cuda_stream)
    from gill_tpu_torch.ops._build import check

    check(err, "prefix_decode_attention")
    prefix_decode_attention.launches += 1
    return out


prefix_decode_attention.launches = 0
