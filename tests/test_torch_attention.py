"""gill_tpu_torch.ops.attention against gill_tpu.ops.attention.

The plain `flash_attention_ref` is held against the Pallas kernels run in
interpret mode on the CPU (as tests/test_attention.py runs them), the
decode path against `_decode_attention`, the einsum path against
`_xla_attention`; the dispatcher's gate is checked case by case. The CUDA
kernel against its plain version is in test_torch_kernels.py.

Tolerances: fp32 2e-5 (the same as test_attention.py's interpret-mode
checks: online vs one-pass softmax and another summation order); bf16
inputs 2^-7 relative + 4e-3 absolute (one bf16 ulp of outputs of
magnitude ~1; both round the probabilities to bf16 before the PV product).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gill_tpu.ops import attention as jattn
from gill_tpu_torch.ops import attention as tattn

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _qkv(seed, b, t, s, h, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, h, d).astype(np.float32),
            rng.randn(b, s, h, d).astype(np.float32),
            rng.randn(b, s, h, d).astype(np.float32))


def _torch(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [40, 64, 128])
def test_flash_ref_matches_pallas_interpret(d, causal):
    q, k, v = _qkv(d, 1, 96, 96, 2, d)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     block_q=64, block_k=64)
    got = tattn.flash_attention(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("s", [77, 130])
def test_flash_ref_padded_kv_matches_pallas_interpret(s, fast):
    """Ragged key lengths (SD's 77-token cross-attention) are masked; the
    Pallas `fast` clamp-shift softmax equals the exact one."""
    q, k, v = _qkv(s, 2, 64, s, 2, 40)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=False,
                                     block_q=64, block_k=128, fast=fast)
    got = tattn.flash_attention(*_torch(q, k, v), causal=False, fast=fast)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("d,s", [(40, 77), (80, 96)])
def test_flash_ref_matches_pallas_bthd_interpret(d, s):
    """flash_attention_bthd takes the head dim zero-padded to 128 lanes and
    the true-d scale; the port takes the true head dim directly."""
    q, k, v = _qkv(d + s, 2, 64, s, 3, d)
    pad = [(0, 0), (0, 0), (0, 0), (0, 128 - d)]
    with pltpu.force_tpu_interpret_mode():
        want = jattn.flash_attention_bthd(
            jnp.pad(q, pad), jnp.pad(k, pad), jnp.pad(v, pad), causal=False,
            scale=1.0 / math.sqrt(d), block_q=64, block_k=128, fast=True)
    got = tattn.flash_attention(*_torch(q, k, v), causal=False,
                                scale=1.0 / math.sqrt(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., :d],
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("block_q,block_k", [(0, 0), (64, 64), (64, 128),
                                             (128, 64), (128, 128)])
@pytest.mark.parametrize("d,t,s", [(40, 96, 200), (80, 130, 77)])
def test_flash_blocks_match_pallas_bthd_interpret(d, t, s, block_q, block_k):
    """bf16 at the UNet's head dims with the kernel's block_q / block_k
    (the plain version ignores the tile on the CPU) against gill_tpu's
    flash_attention_bthd with the same blocks (its own tiles: online
    softmax over key blocks, ragged query and key edges), in interpret
    mode; 0 = each side's automatic choice. Tolerance as for bf16 above:
    2^-7 relative + 4e-3 absolute, one bf16 ulp of outputs ~1 (the Pallas
    kernel rounds p to bf16 against the running max of its key blocks,
    the plain version against the row's final max)."""
    q, k, v = _qkv(d + t + s, 2, t, s, 2, d)
    pad = [(0, 0), (0, 0), (0, 0), (0, 128 - d)]
    with pltpu.force_tpu_interpret_mode():
        want = jattn.flash_attention_bthd(
            *(jnp.pad(jnp.asarray(a, jnp.bfloat16), pad) for a in (q, k, v)),
            causal=False, scale=1.0 / math.sqrt(d), block_q=block_q,
            block_k=block_k)
    got = tattn.flash_attention(*_torch(q, k, v, dtype=torch.bfloat16),
                                block_q=block_q, block_k=block_k)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32))[..., :d],
                               atol=4e-3, rtol=2.0 ** -7)


@pytest.mark.parametrize("dtype,d,block_q,block_k", [
    (torch.bfloat16, 40, 32, 0), (torch.bfloat16, 40, 0, 256),
    (torch.bfloat16, 80, 96, 64), (torch.bfloat16, 80, -64, 64),
    (torch.float32, 40, 64, 64), (torch.bfloat16, 128, 0, 64)])
def test_flash_refuses_unsupported_blocks_on_cpu(dtype, d, block_q, block_k):
    """The tile check runs before the CPU's plain version: a block the
    kernel does not take, or any block for a call the bf16 d <= 80 kernel
    does not take (fp32, d > 80), raises ValueError."""
    q = torch.zeros(1, 16, 2, d, dtype=dtype)
    with pytest.raises(ValueError):
        tattn.flash_attention(q, q, q, block_q=block_q, block_k=block_k)


def test_mma_tile_by_shape():
    """The automatic tile: 128 query rows but for T <= 64, 64 keys; given
    blocks are taken as they are."""
    assert tattn.mma_tile(4096) == (128, 64)
    assert tattn.mma_tile(1024) == (128, 64)
    assert tattn.mma_tile(64) == (64, 64)
    assert tattn.mma_tile(4096, block_q=64, block_k=128) == (64, 128)
    assert tattn.mma_tile(100, block_k=128) == (128, 128)
    assert tattn.mma_eligible(torch.bfloat16, 80)
    assert not tattn.mma_eligible(torch.bfloat16, 88)
    assert not tattn.mma_eligible(torch.float32, 40)


@pytest.mark.parametrize("t,s,d,q_block", [(96, 77, 40, 50), (64, 33, 36, 64),
                                           (130, 130, 80, 1024),
                                           (40, 24, 128, 16)])
def test_quantize_qk_ref_layout(t, s, d, q_block):
    """K10's pre-pass layout on the CPU against numpy: q per (b, h, group
    of q_block rows, the last one partial), k per (b, h), scale
    max(amax / 127, 1e-12) in float32, values rint(x / scale) clipped to
    +-127, rows (b * H + h) zero-padded to a multiple of 16 bytes."""
    b, h = 2, 3
    q, k, _ = _qkv(t + s + d, b, t, s, h, d)
    qb = torch.from_numpy(q).bfloat16()
    kb = torch.from_numpy(k).bfloat16()
    got = tattn.quantize_qk(qb, kb, q_block=q_block)
    rb = -(-d // 16) * 16

    def quant(x):
        amax = np.float32(np.abs(x).max())
        sc = np.maximum(amax / np.float32(127.0), np.float32(1e-12))
        return np.clip(np.rint(x / sc), -127, 127).astype(np.int8), sc

    qf, kf = qb.float().numpy(), kb.float().numpy()
    for bi in range(b):
        for hi in range(h):
            r = bi * h + hi
            kq, sk = quant(kf[bi, :, hi])
            assert np.array_equal(got.kq[r, :, :d].numpy(), kq)
            assert got.sk[r].item() == sk
            for gi, r0 in enumerate(range(0, t, q_block)):
                qq, sq = quant(qf[bi, r0:r0 + q_block, hi])
                assert np.array_equal(
                    got.qq[r, r0:r0 + q_block, :d].numpy(), qq)
                assert got.sq[r, gi].item() == sq
    assert got.qq.shape == (b * h, t, rb) and got.kq.shape == (b * h, s, rb)
    assert not got.qq[..., d:].any() and not got.kq[..., d:].any()


def test_flash_ref_bf16_matches_pallas_interpret():
    q, k, v = _qkv(5, 1, 64, 77, 2, 64)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.flash_attention(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
            jnp.asarray(v, jnp.bfloat16), causal=False, block_q=64,
            block_k=128)
    got = tattn.flash_attention(*_torch(q, k, v, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=4e-3, rtol=2.0 ** -7)


def test_flash_ref_kv_len_masks_tail():
    q, k, v = _qkv(6, 1, 8, 12, 2, 16)
    q, k, v = _torch(q, k, v)
    got = tattn.flash_attention_ref(q, k, v, kv_len=9)
    want = tattn.flash_attention_ref(q, k[:, :9], v[:, :9])
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("causal,kv_offset", [(False, None), (True, None),
                                              (True, 3)])
def test_xla_attention_matches_gill_tpu(causal, kv_offset):
    q, k, v = _qkv(7, 2, 5, 9, 2, 16)
    want = jattn._xla_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, scale=0.25,
                                kv_offset=kv_offset)
    got = tattn._xla_attention(*_torch(q, k, v), causal=causal, scale=0.25,
                               kv_offset=kv_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("extra", [False, True])
def test_decode_attention_matches_gill_tpu(per_row, extra):
    """Single-token decode over a cache with scalar or per-row (B,)
    kv_offset, with or without the token's own k/v (extra_kv)."""
    q, k, v = _qkv(8, 3, 1, 10, 2, 16)
    rng = np.random.RandomState(9)
    k1, v1 = (rng.randn(3, 1, 2, 16).astype(np.float32) for _ in range(2))
    off = np.array([2, 9, 5], np.int32) if per_row else 6
    jkw = dict(scale=0.25, kv_offset=jnp.asarray(off))
    tkw = dict(scale=0.25,
               kv_offset=torch.from_numpy(off).long() if per_row else off)
    if extra:
        jkw["extra_kv"] = (jnp.asarray(k1), jnp.asarray(v1))
        tkw["extra_kv"] = tuple(_torch(k1, v1))
    want = jattn._decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **jkw)
    got = tattn._decode_attention(*_torch(q, k, v), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-5)


def test_dispatcher_decode_equals_jax_dispatcher():
    q, k, v = _qkv(10, 2, 1, 12, 2, 16)
    want = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True,
                                       kv_offset=jnp.asarray(7))
    got = tattn.dot_product_attention(*_torch(q, k, v), causal=True,
                                      kv_offset=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-5)


@pytest.mark.parametrize("case,expect", [
    (dict(on_cuda=True, t=300, s=300, has_bias=False, has_kv_offset=False,
          impl="auto"), True),
    (dict(on_cuda=False, t=300, s=300, has_bias=False, has_kv_offset=False,
          impl="auto"), False),
    (dict(on_cuda=True, t=300, s=255, has_bias=False, has_kv_offset=False,
          impl="auto"), False),
    (dict(on_cuda=True, t=1, s=300, has_bias=False, has_kv_offset=False,
          impl="auto"), False),
    (dict(on_cuda=True, t=300, s=300, has_bias=True, has_kv_offset=False,
          impl="auto"), False),
    (dict(on_cuda=True, t=300, s=300, has_bias=False, has_kv_offset=True,
          impl="auto"), False),
    (dict(on_cuda=True, t=300, s=300, has_bias=False, has_kv_offset=False,
          impl="xla"), False),
    (dict(on_cuda=False, t=64, s=77, has_bias=False, has_kv_offset=False,
          impl="flash"), True),
])
def test_flash_gate(case, expect):
    """gill_tpu's gate (attention.py:611-615) with CUDA in place of TPU."""
    assert tattn.flash_eligible(**case) is expect


def test_dispatcher_routes(monkeypatch):
    calls = []

    def spy(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return tattn.flash_attention_ref(q, k, v, causal=kw["causal"],
                                         scale=kw["scale"])

    monkeypatch.setattr(tattn, "flash_attention", spy)
    q, k, v = _torch(*_qkv(11, 1, 8, 300, 2, 16))
    tattn.dot_product_attention(q, k, v)                  # CPU, auto: plain
    assert calls == []
    tattn.dot_product_attention(q, k, v, impl="flash")    # forced
    assert calls == [(1, 8, 2, 16)]
    with pytest.raises(ValueError):
        tattn.dot_product_attention(q, k, v, extra_kv=(k, v))
