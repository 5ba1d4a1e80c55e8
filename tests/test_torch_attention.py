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
