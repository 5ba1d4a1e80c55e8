"""gill_tpu_torch.ops.attention `flash_attention_q8_ref` (the plain
version of the int8-QK kernel) against gill_tpu's Pallas
`flash_attention_bthd(q8=True)` (`_flash_kernel_i8`) run in interpret mode
on the CPU, with q/k/v zero-padded to 128 lanes for gill_tpu only (zero
lanes change neither an amax nor a product). The CUDA kernel against the
plain version is in test_torch_kernels.py.

Tolerances: fp32 1e-5 (the same int8 values and int32 scores; the softmax
and PV sums run in another order); against exact fp32 attention 0.02
absolute, the bound of gill_tpu's test_flash_bthd_int8_qk_close_to_xla.
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


def _qkv(seed, b, t, s, h, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, h, d).astype(np.float32),
            (1.5 * rng.randn(b, s, h, d)).astype(np.float32),
            rng.randn(b, s, h, d).astype(np.float32))


@pytest.mark.parametrize("t,s", [(128, 128), (96, 77)])
def test_q8_ref_matches_pallas_interpret(t, s):
    """q_block 64 = gill_tpu's block_q: (96, 77) has a partial last query
    group (rows 64..95) and ragged keys (77 of a 128-key block)."""
    d = 40
    q, k, v = _qkv(t + s, 2, t, s, 2, d)
    pad = [(0, 0), (0, 0), (0, 0), (0, 128 - d)]
    s_pad = -(-s // 128) * 128
    with pltpu.force_tpu_interpret_mode():
        want = jattn.flash_attention_bthd(
            *(jnp.pad(jnp.asarray(a), pad) for a in (q, k, v)), causal=False,
            scale=1.0 / math.sqrt(d), block_q=64, block_k=s_pad, q8=True)
    want = np.asarray(want)[..., :d]
    got = tattn.flash_attention_q8(*(torch.from_numpy(a) for a in (q, k, v)),
                                   scale=1.0 / math.sqrt(d), q_block=64)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_q8_ref_close_to_exact_attention():
    """Mirrors gill_tpu's test_flash_bthd_int8_qk_close_to_xla on the port:
    int8 q/k quantization moves the scores by ~1e-2, the outputs by less
    than 0.02."""
    d = 40
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(2, 128, 2, d).astype(np.float32))
               for _ in range(3))
    out = tattn.flash_attention_q8(q, k, v, scale=1.0 / math.sqrt(d),
                                   q_block=64)
    ref = tattn._xla_attention(q, k, v, causal=False, scale=1.0 / math.sqrt(d))
    assert float((out - ref).abs().max()) < 0.02


def test_q8_ref_default_group_is_one_scale_per_1024_rows():
    """With the default q_block (gill_tpu's block_q at every UNet shape),
    rows 0..1023 share one q scale: scaling a row beyond the first 1024
    changes nothing in rows 0..1023."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 1, 1100, 16, 1, 8))
    a = tattn.flash_attention_q8(q, k, v, scale=0.3)
    q2 = q.clone()
    q2[:, 1050] *= 50.0
    b = tattn.flash_attention_q8(q2, k, v, scale=0.3)
    torch.testing.assert_close(a[:, :1024], b[:, :1024], atol=0, rtol=0)
    assert not torch.equal(a[:, 1024:], b[:, 1024:])
