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
    `impl="flash"` -> `flash_attention` (csrc/flash_mma.cu for bf16 at head
    dims <= 80, csrc/flash_attn.cu otherwise);
  * everything else -> `_xla_attention` (plain einsum + softmax).
gill_tpu gates its prefix-decode kernel behind GILL_PREFIX_DECODE_MIN
(default 0, off): on a TPU v5e the Pallas call serialised its cache DMA
against XLA's overlapped weight stream and lost end to end. That reason is
the TPU's scheduler, not the function, so the threshold is not ported: on
a GPU every kernel is its own launch anyway. The chunked valid-prefix
decode behind GILL_DECODE_CHUNK_MIN (default off) is not ported.

`flash_attention` launches a CUDA kernel for CUDA tensors and raises if it
cannot; a CPU tensor takes `flash_attention_ref`, its plain version.
`flash_attention_q8` (the UNet's `q8=True` mode, gill_tpu
`flash_attention_bthd(q8=True)`) does the same with csrc/flash_mma.cu's
pre-pass and int8 QK stage and `flash_attention_q8_ref`.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

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
# the CUDA kernels: csrc/flash_attn.cu (K1) and csrc/flash_mma.cu (K2, K10)
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 512
# bf16 calls up to this head dim take csrc/flash_mma.cu (K2), at the tile
# (block_q, block_k) in MMA_TILES x MMA_TILES
MMA_MAX_HEAD_DIM = 80
MMA_TILES = (64, 128)


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


def _mma_lib():
    from gill_tpu_torch.ops import _build

    lib = _build.load("flash_mma")
    if lib.gill_flash_mma.argtypes is None:
        i, ll, p, f = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, \
            ctypes.c_float
        lib.gill_flash_mma.argtypes = [p] * 4 + [i] * 5 + [ll] * 9 + [
            f, i, i, i, i, p]
        lib.gill_flash_mma_q8_prepass.argtypes = [p] * 7 + [ll] + [i] * 6 + [
            ll] * 6 + [p]
        lib.gill_flash_mma_q8.argtypes = [p] * 6 + [i] * 6 + [ll] * 3 + [
            f, i, i, p]
        lib.gill_flash_mma_q8_check_division.argtypes = [p, p]
        for fn in (lib.gill_flash_mma, lib.gill_flash_mma_q8_prepass,
                   lib.gill_flash_mma_q8, lib.gill_flash_mma_q8_check_division):
            fn.restype = i
    return lib


def mma_eligible(dtype, d: int) -> bool:
    """Whether a call of this dtype and head dim takes csrc/flash_mma.cu."""
    return dtype == torch.bfloat16 and 0 < d <= MMA_MAX_HEAD_DIM


def mma_tile(t: int, block_q: int = 0, block_k: int = 0) -> tuple:
    """(BQ, BK), the query rows and keys a step of csrc/flash_mma.cu: each
    of block_q / block_k as given (one of MMA_TILES) or, when 0, chosen
    from the shape: 128 query rows (eight warps share each K/V tile; the
    fastest at all four UNet shapes on the H100, 32 x 32 self-attention's
    128 blocks for 132 SMs included), 64 where T <= 64 leaves the rest of
    the warps idle; 64 keys (128 holds twice the scores in registers and
    was slower everywhere). Any other value raises ValueError. gill_tpu's
    `flash_attention_bthd(block_q=, block_k=)` takes TPU-sized blocks;
    these are the Hopper kernel's own."""
    for name, val in (("block_q", block_q), ("block_k", block_k)):
        if val != 0 and val not in MMA_TILES:
            raise ValueError(f"{name} {val}: the kernel takes 0 (by shape) "
                             f"or one of {MMA_TILES}")
    return block_q or (64 if t <= 64 else 128), block_k or 64


def _mma_ready(x, d8: int):
    """x zero-padded to head dim d8 (a copy), or copied contiguous when its
    base or strides break the kernel's 16-byte rows, else x itself."""
    if x.shape[-1] != d8:
        return torch.nn.functional.pad(x, (0, d8 - x.shape[-1]))
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(
            st % 8 for st in x.stride()[:-1]):
        return x.clone(memory_format=torch.contiguous_format)
    return x


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None, fast: bool = False,
                    block_q: int = 0, block_k: int = 0):
    """Flash attention, q (B,T,H,D), k/v (B,S,H,D) -> contiguous (B,T,H,D).

    Replaces gill_tpu `flash_attention` (K1) and `flash_attention_bthd`
    (K2): strided inputs at the true head dim (no lane padding, no
    transposes); `scale` defaults to 1/sqrt(D); keys at or beyond `kv_len`
    are masked. `fast` (the Pallas clamp-shift softmax) is accepted and
    computed exactly. CUDA tensors launch a kernel or raise: bf16 at D <= 80
    csrc/flash_mma.cu at the tile `mma_tile(T, block_q, block_k)` gives (it
    counts on `flash_attention.mma_launches`), fp32 at D <= 512 and bf16 at
    80 < D <= 512 csrc/flash_attn.cu (`flash_attention.launches`), whose
    tile follows the head dim: there a nonzero block_q / block_k raises.
    CPU tensors take `flash_attention_ref`, after the same checks of
    block_q / block_k."""
    del fast
    b, t, h, d = q.shape
    s = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    kv_len = s if kv_len is None else int(kv_len)
    if not 0 < kv_len <= s:
        raise ValueError(f"kv_len {kv_len} outside (0, {s}]")
    mma = mma_eligible(q.dtype, d)
    if mma:
        bq, bk = mma_tile(t, block_q, block_k)
    elif block_q or block_k:
        raise ValueError(f"block_q / block_k pick the tile of the bf16 "
                         f"kernel at head dims <= {MMA_MAX_HEAD_DIM}; a "
                         f"{q.dtype} call at head dim {d} has none")
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
    from gill_tpu_torch.ops._build import check

    if mma:
        d8 = -(-d // 8) * 8
        q, k, v = (_mma_ready(x, d8) for x in (q, k, v))
        out = torch.empty((b, t, h, d8), device=q.device, dtype=q.dtype)
        err = _mma_lib().gill_flash_mma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, s, h, d8, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], scale, int(causal), kv_len, bq, bk, _stream(q))
        check(err, "flash_attention (flash_mma)")
        flash_attention.mma_launches += 1
        return out if d8 == d else out[..., :d].contiguous()
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty((b, t, h, d), device=q.device, dtype=q.dtype)
    err = _flash_lib()(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), b, t, s, h, d,
                       q.stride(0), q.stride(1), q.stride(2),
                       k.stride(0), k.stride(1), k.stride(2),
                       v.stride(0), v.stride(1), v.stride(2),
                       scale, int(causal), kv_len, _stream(q))
    check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.mma_launches = 0


# ---------------------------------------------------------------------------
# int8-QK flash attention (csrc/flash_mma.cu, the int8 QK stage)
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


Q8_MAX_HEAD_DIM = 128


class QK8(NamedTuple):
    """K10's int8 operands in the kernel's layout: qq (B*H, T, RB) and kq
    (B*H, S, RB) int8, RB = D rounded up to 16, zero past D; sq (B*H,
    ceil(T / q_block)) and sk (B*H,) fp32 scales."""
    qq: torch.Tensor
    kq: torch.Tensor
    sq: torch.Tensor
    sk: torch.Tensor


def quantize_qk_ref(q, k, *, q_block: int = 1024) -> QK8:
    """Plain version of K10's pre-pass: `flash_attention_q8_ref`'s
    quantization (`_int8_sym`) laid out as the kernel takes it."""
    b, t, h, d = q.shape
    ng, rb = -(-t // q_block), -(-d // 16) * 16
    kq, sk = _int8_sym(k, (1, 3))                       # sk (B, 1, H, 1)
    qg = torch.nn.functional.pad(q.float(), (0, 0, 0, 0, 0, ng * q_block - t))
    qq, sq = _int8_sym(qg.reshape(b, ng, q_block, h, d), (2, 4))
    qq = qq.reshape(b, ng * q_block, h, d)[:, :t]

    def rows(x):
        x = x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], d)
        return torch.nn.functional.pad(x, (0, rb - d)).to(torch.int8)

    return QK8(rows(qq), rows(kq),
               sq.reshape(b, ng, h).permute(0, 2, 1).reshape(b * h, ng),
               sk.reshape(b * h))


def _q8_check(q, k, v, q_block):
    b, t, h, d = q.shape
    s = k.shape[1]
    if k.shape != (b, s, h, d) or (v is not None and v.shape != k.shape):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {None if v is None else tuple(v.shape)}")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v) if x is not None):
        raise TypeError("flash_attention_q8 takes bf16 q, k and v")
    if not 0 < d <= Q8_MAX_HEAD_DIM or q_block <= 0 or t == 0 or s == 0:
        raise ValueError(f"flash_attention_q8: head dim {d} (at most "
                         f"{Q8_MAX_HEAD_DIM}), q_block {q_block}, T {t}, S {s}")
    if any(x.device != q.device for x in (k, v) if x is not None):
        raise ValueError("q, k and v must share one device")


def quantize_qk(q, k, *, q_block: int = 1024) -> QK8:
    """K10's pre-pass: q int8 per (b, h, group of q_block rows), k per
    (b, h), in the kernel's layout (`QK8`). CUDA tensors launch the two
    pre-pass kernels of csrc/flash_mma.cu (bf16, D <= 128) or raise; CPU
    tensors take `quantize_qk_ref`."""
    if not q.is_cuda:
        return quantize_qk_ref(q, k, q_block=q_block)
    _q8_check(q, k, None, q_block)
    b, t, h, d = q.shape
    s = k.shape[1]
    q, k = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k))
    ng, rb = -(-t // q_block), -(-d // 16) * 16
    # one block maximum a 64-row part of each q group and of the keys
    nparts = b * h * (ng * -(-min(q_block, t) // 64) + -(-s // 64))
    dev = q.device
    out = QK8(torch.empty((b * h, t, rb), device=dev, dtype=torch.int8),
              torch.empty((b * h, s, rb), device=dev, dtype=torch.int8),
              torch.empty((b * h, ng), device=dev, dtype=torch.float32),
              torch.empty((b * h,), device=dev, dtype=torch.float32))
    part = torch.empty((nparts,), device=dev, dtype=torch.float32)
    err = _mma_lib().gill_flash_mma_q8_prepass(
        q.data_ptr(), k.data_ptr(), *(x.data_ptr() for x in out),
        part.data_ptr(), nparts, b, t, s, h, d, q_block,
        *q.stride()[:3], *k.stride()[:3], _stream(q))
    from gill_tpu_torch.ops._build import check

    check(err, "quantize_qk (flash_mma pre-pass)")
    return out


def flash_attention_q8(q, k, v, *, scale: float, q_block: int = 1024,
                       qk8: Optional[QK8] = None):
    """Int8-QK attention, q (B,T,H,D), k/v (B,S,H,D) -> contiguous
    (B,T,H,D), non-causal. Replaces gill_tpu `flash_attention_bthd(q8=
    True)` (Pallas `_flash_kernel_i8`): q and k quantized dynamically, q
    per group of q_block rows (1024, gill_tpu's block_q at every UNet
    shape; here the group only, not the tile), int8 QK with int32 sums,
    exact softmax, bf16 PV. CUDA tensors (bf16, D <= 128, strided views
    taken as they are) launch `quantize_qk`'s pre-pass, unless `qk8`
    holds its result for these q and k already, then csrc/flash_mma.cu's
    int8 stage at the tile `mma_tile` picks from the shape (counted on
    `flash_attention_q8.launches` and `flash_attention.mma_launches`), or
    raise; CPU tensors take `flash_attention_q8_ref`."""
    b, t, h, d = q.shape
    s = k.shape[1]
    if not q.is_cuda:
        return flash_attention_q8_ref(q, k, v, scale=scale, q_block=q_block)
    _q8_check(q, k, v, q_block)
    if qk8 is None:
        qk8 = quantize_qk(q, k, q_block=q_block)
    rb = -(-d // 16) * 16
    want = ((b * h, t, rb), (b * h, s, rb), (b * h, -(-t // q_block)),
            (b * h,))
    if tuple(tuple(x.shape) for x in qk8) != want:
        raise ValueError(f"qk8 shapes {[tuple(x.shape) for x in qk8]}, "
                         f"want {want}")
    d8 = -(-d // 8) * 8
    v = _mma_ready(v, d8)
    bq, bk = mma_tile(t)
    out = torch.empty((b, t, h, d8), device=q.device, dtype=q.dtype)
    err = _mma_lib().gill_flash_mma_q8(
        *(x.data_ptr() for x in qk8), v.data_ptr(), out.data_ptr(),
        b, t, s, h, d8, q_block, *v.stride()[:3], float(scale), bq, bk,
        _stream(q))
    from gill_tpu_torch.ops._build import check

    check(err, "flash_attention_q8 (flash_mma)")
    flash_attention_q8.launches += 1
    flash_attention.mma_launches += 1
    return out if d8 == d else out[..., :d].contiguous()


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
