"""The attention sweep's flash-attention variants (S2, S3): the
hand-written CUDA kernel + their plain versions.

Counterpart of scripts/attn_sweep.py `make_flash(block_q, block_k,
prob_dtype, kt)` (S2) and `make_flash_nomax(block_q, block_k)` (S3), for
q, k, v (B, T|S, H, D) bf16 -> bf16, scale 1/sqrt(D), no mask:
  * S2 with block_k == S is single-pass (the row max over every key before
    any exp, no rescale); block_k < S is online (a running max, the alpha
    rescale every block_k keys). prob_dtype bf16: p = exp(bf16(s - m)) in
    bf16, l sums p in fp32; fp32: l sums the fp32 p, P.V takes p rounded to
    bf16. kt: k is handed to the kernel as (B*H, D, S), transposed inside
    the call as the original's wrapper does;
  * S3: p = exp(s - 12) in fp32 with no max and no clamp (scores above
    ~100 overflow, as in the original), l and P.V in fp32.
Both end in acc / max(l, 1e-30) rounded once to bf16. The original's grid
silently drops a tail (`num_kb = seq_k // block_k`); here T % block_q and
S % block_k must be 0, or the call raises. D is a multiple of 8, at most 48
(the sweep's is 40).

The Hopper kernel (csrc/flash_variants.cu) is K2's mma.sync design (Q, S,
P and O in registers, a cp.async K/V ring) with each variant as a mode,
and runs its own tile, not the TPU's VMEM-sized blocks: `hopper_tile` maps
a variant's block_q to (BQ, BK) query rows and keys a step, and
`variant_plan` gives the whole launch, which the C side checks. Single-pass
is two sweeps over the keys (the max, then exp and P.V); its online mode
rescales every BK keys, which differs from rescaling every block_k keys
only in where p rounds to bf16 against the running max and in fp32
rounding (the module's tests and chip_smoke.py hold it to two bf16 ulps of
the largest output).

CUDA tensors launch the kernel or raise; CPU tensors take the plain
versions `flash_variant_ref` / `flash_nomax_ref`.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

NEG_INF = -1e30        # the original's _NEG_INF
NOMAX_SHIFT = 12.0     # S3's fixed shift
MAX_HEAD_DIM = 48
SINGLE, ONLINE, NOMAX = 0, 1, 2


def hopper_tile(block_q: int) -> tuple:
    """(BQ, BK): the Hopper tile that stands for a TPU block_q of 256 and
    less (64 x 64), up to 512 (128 x 64) or more (64 x 128: 64 rows and 128
    keys a step). A 128 x 128 tile, one block of eight warps an SM by its
    registers, was slower than 64 x 128 on the H100."""
    if block_q <= 256:
        return 64, 64
    return (128, 64) if block_q <= 512 else (64, 128)


STAGES = 2                # the K/V ring's stages
MAX_SMEM = 232448         # shared memory a block can have on an H100
MAX_GRID_Y = 65535


class VariantPlan(NamedTuple):
    """One launch of csrc/flash_variants.cu: (bq, bk) query rows and keys a
    step (`hopper_tile`), Q K^T as `k16` m16n8k16 steps and, where `k8`,
    one m16n8k8 step (D / 8 chunks of 16 bytes: odd D / 8 ends in k8), a
    K/V ring of `stages` stages, `smem` bytes of shared memory a block and
    `grid` (query tiles, B * H) blocks of bq / 16 warps."""
    bq: int
    bk: int
    k16: int
    k8: bool
    stages: int
    smem: int
    grid: Tuple[int, int]


def _odd(n: int) -> int:
    return n | 1


def variant_plan(b: int, t: int, s: int, h: int, d: int, mode: int,
                 bf16_probs: bool, kt: bool, block_q: int) -> VariantPlan:
    """The geometry csrc/flash_variants.cu's `plan_for` gives for q (b, t,
    h, d) and k/v (b, s, h, d) (the C side refuses any other). Shared
    memory: the Q tile (bq rows, also the epilogue's staging) and `stages`
    K and V slots, each row an odd number of 16-byte chunks (ldmatrix's
    eight rows in eight bank groups); with kt the K tile is [depth][key],
    8 D / 8 rows of bk keys, and the V slot is as large as the larger
    tile (single-pass's first sweep puts a second K tile there at bq 128).
    Raises ValueError where the kernel does not take the call: D not a
    multiple of 8 in (0, 48], T not a multiple of block_q, kt with S not a
    multiple of 8, no-max with bf16 probabilities or kt (S3 has neither),
    B * H past the grid."""
    if not 0 < d <= MAX_HEAD_DIM or d % 8:
        raise ValueError(f"head dim {d} (a multiple of 8, at most "
                         f"{MAX_HEAD_DIM})")
    if min(b, t, s, h) <= 0 or block_q <= 0 or t % block_q:
        raise ValueError(f"B {b} T {t} S {s} H {h}: T must divide into "
                         f"block_q {block_q}")
    if mode not in (SINGLE, ONLINE, NOMAX):
        raise ValueError(f"mode {mode}")
    if mode == NOMAX and (bf16_probs or kt):
        raise ValueError("the no-max variant has fp32 probabilities and k "
                         "as (B, S, H, D)")
    if kt and s % 8:
        raise ValueError(f"kt takes S a multiple of 8, got {s}")
    if b * h > MAX_GRID_Y:
        raise ValueError(f"B * H = {b * h} blocks past the grid's "
                         f"{MAX_GRID_Y}")
    bq, bk = hopper_tile(block_q)
    nc = d // 8
    kbytes = 8 * nc * _odd(bk // 8) * 16 if kt else bk * _odd(nc) * 16
    vbytes = max(kbytes, bk * _odd(nc) * 16)
    smem = bq * _odd(nc) * 16 + STAGES * (kbytes + vbytes)
    return VariantPlan(bq, bk, nc // 2, nc % 2 == 1, STAGES, smem,
                       (-(-t // bq), b * h))


def _check(q, k, v, block_q: int, block_k: int):
    b, t, h, d = q.shape
    s = k.shape[1]
    if block_q <= 0 or block_k <= 0 or t % block_q or s % block_k:
        raise ValueError(f"T {t} and S {s} must divide into block_q "
                         f"{block_q} and block_k {block_k}")
    if k.shape != (b, s, h, d) or v.shape != (b, s, h, d):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise TypeError(f"the flash variants take bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not 0 < d <= MAX_HEAD_DIM or d % 8:
        raise ValueError(f"head dim {d} (a multiple of 8, at most "
                         f"{MAX_HEAD_DIM})")


def _to_bhtd(x):
    return x.permute(0, 2, 1, 3).float()


def flash_variant_ref(q, k, v, *, block_k: int, bf16_probs: bool = False):
    """Plain version of S2, the original's loop over key blocks of block_k:
    fp32 scores of the bf16 operands times scale, m_new = max(m, block
    max), p = exp(s - m_new) (bf16 probabilities: exp of the bf16-rounded
    argument, in bf16), alpha = exp(m - m_new), l = l * alpha + sum(p),
    acc = acc * alpha + bf16(p) . v in fp32; out = acc / max(l, 1e-30)."""
    b, t, h, d = q.shape
    s = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = _to_bhtd(q), _to_bhtd(k), _to_bhtd(v)
    m = torch.full((b, h, t, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, t, 1), device=q.device)
    acc = torch.zeros((b, h, t, d), device=q.device)
    for k0 in range(0, s, block_k):
        sc = torch.matmul(qf, kf[:, :, k0:k0 + block_k].transpose(-1, -2))
        sc.mul_(scale)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        sc.sub_(m_new)
        p = torch.exp(sc.to(torch.bfloat16)) if bf16_probs else sc.exp_()
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.float().sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(),
                                         vf[:, :, k0:k0 + block_k])
        m = m_new
        del sc, p
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def flash_nomax_ref(q, k, v):
    """Plain version of S3: p = exp(s - 12) of the fp32 scores, l = sum(p),
    acc = bf16(p) . v in fp32, out = acc / max(l, 1e-30)."""
    d = q.shape[-1]
    qf, kf, vf = _to_bhtd(q), _to_bhtd(k), _to_bhtd(v)
    sc = torch.matmul(qf, kf.transpose(-1, -2)).mul_(1.0 / math.sqrt(d))
    p = sc.sub_(NOMAX_SHIFT).exp_()
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), vf)
    return (acc / l.clamp_min(1e-30)).permute(0, 2, 1, 3).to(q.dtype)


def _lib():
    from gill_tpu_torch.ops import _build

    lib = _build.load("flash_variants")
    if lib.gill_flash_variant.argtypes is None:
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.gill_flash_variant.argtypes = [p] * 4 + [i] * 13 + [ll] * 10 \
            + [ctypes.c_float, p]
        lib.gill_flash_variant.restype = i
        lib.gill_flash_variant_plan.argtypes = [i] * 9 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.gill_flash_variant_plan.restype = i
    return lib


def c_plan(b: int, t: int, s: int, h: int, d: int, mode: int,
           bf16_probs: bool, kt: bool, block_q: int):
    """The `VariantPlan` the C side makes for the call, or None where it
    refuses it (builds the library)."""
    out = (ctypes.c_int * 8)()
    err = _lib().gill_flash_variant_plan(b, t, s, h, d, mode, int(bf16_probs),
                                         int(kt), block_q, out)
    if err:
        return None
    *head, gx, gy = tuple(out)
    return VariantPlan(*head[:3], bool(head[3]), *head[4:], (gx, gy))


def _aligned(x) -> bool:
    """The kernel's 16-byte loads: an aligned base, 8-element strides."""
    return x.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for st in x.stride()[:-1])


def _launch(q, k, v, *, mode: int, bf16_probs: bool, kt: bool, block_q: int):
    b, t, h, d = q.shape
    s = k.shape[1]
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must share one device")
    plan = variant_plan(b, t, s, h, d, mode, bf16_probs, kt, block_q)
    q, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, v))
    if kt:
        # the original's wrapper hands the kernel k as (B*H, D, S)
        # (a copy: reshape alone can return a strided view when B = 1)
        k = k.permute(0, 2, 3, 1).contiguous().view(b * h, d, s)
        k_strides = (h * d * s, 1, d * s, s)
    else:
        k = k if k.stride(-1) == 1 else k.contiguous()
        k_strides = (k.stride(0), k.stride(1), k.stride(2), 1)
    if not all(_aligned(x) for x in (q, k, v)):
        raise ValueError("the kernel loads 16 bytes at a time: q, k and v "
                         "must be 16-byte aligned with strides of 8 "
                         "elements")
    out = torch.empty((b, t, h, d), device=q.device, dtype=q.dtype)
    err = _lib().gill_flash_variant(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, s, h,
        d, mode, int(bf16_probs), int(kt), block_q, plan.bq, plan.bk,
        plan.stages, plan.smem, q.stride(0), q.stride(1), q.stride(2),
        *k_strides, v.stride(0), v.stride(1), v.stride(2),
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    from gill_tpu_torch.ops._build import check

    check(err, "flash variant")
    return out


def flash_variant(q, k, v, *, block_q: int, block_k: int,
                  prob_dtype=torch.float32, kt: bool = False):
    """S2, scripts/attn_sweep.py `make_flash(block_q, block_k, prob_dtype,
    kt)` applied to (q, k, v): single-pass when block_k == S, else
    online. CUDA tensors launch the kernel or raise; CPU tensors take
    `flash_variant_ref`."""
    _check(q, k, v, block_q, block_k)
    if prob_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"prob_dtype {prob_dtype}")
    bf16_probs = prob_dtype == torch.bfloat16
    if not q.is_cuda:
        return flash_variant_ref(q, k, v, block_k=block_k,
                                 bf16_probs=bf16_probs)
    mode = SINGLE if block_k == k.shape[1] else ONLINE
    out = _launch(q, k, v, mode=mode, bf16_probs=bf16_probs, kt=kt,
                  block_q=block_q)
    flash_variant.launches += 1
    return out


flash_variant.launches = 0


def flash_nomax(q, k, v, *, block_q: int, block_k: int):
    """S3, scripts/attn_sweep.py `make_flash_nomax(block_q, block_k)`
    applied to (q, k, v). CUDA tensors launch the kernel or raise; CPU
    tensors take `flash_nomax_ref`."""
    _check(q, k, v, block_q, block_k)
    if not q.is_cuda:
        return flash_nomax_ref(q, k, v)
    out = _launch(q, k, v, mode=NOMAX, bf16_probs=False, kt=False,
                  block_q=block_q)
    flash_nomax.launches += 1
    return out


flash_nomax.launches = 0

