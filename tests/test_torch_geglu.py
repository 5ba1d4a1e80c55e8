"""gill_tpu_torch.ops.geglu against gill_tpu's GEGLU feed-forward.

The plain `geglu_ff_ref` is held against the composed path of gill_tpu's
UNet (`unet._geglu_ff` off-TPU: exact-erf gelu) tightly, and against the
Pallas `geglu_ff` in interpret mode at 2e-3 — the kernel's tanh-form gelu
differs from erf by < 3.2e-4 per element (test_geglu.py:30-33). The CUDA
kernel against its plain version is in test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gill_tpu.models.sd import unet as junet
from gill_tpu.ops.geglu import geglu_ff as pallas_geglu_ff
from gill_tpu_torch.ops import geglu as tgeglu

torch.backends.cuda.matmul.allow_tf32 = False


def _params(seed, d, scale=0.05):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(2, 24, d).astype(np.float32),
            "w1": (scale * rng.randn(d, 8 * d)).astype(np.float32),
            "b1": (scale * rng.randn(8 * d)).astype(np.float32),
            "w2": (scale * rng.randn(4 * d, d)).astype(np.float32),
            "b2": (scale * rng.randn(d)).astype(np.float32)}


def _torch_args(p, dtype=torch.float32):
    return [torch.from_numpy(p[k]).to(dtype)
            for k in ("x", "w1", "b1", "w2", "b2")]


@pytest.mark.parametrize("d", [16, 32, 40])
def test_geglu_ref_matches_composed_unet_ff(d):
    """fp32: 1e-5 (the same three products, summed in another order)."""
    p = _params(d, d)
    jp = {"geglu": {"w": jnp.asarray(p["w1"]), "b": jnp.asarray(p["b1"])},
          "ff_out": {"w": jnp.asarray(p["w2"]), "b": jnp.asarray(p["b2"])}}
    want = junet._geglu_ff(jp, jnp.asarray(p["x"]))
    got = tgeglu.geglu_ff(*_torch_args(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_geglu_ref_bf16_matches_composed_unet_ff():
    """bf16 on both sides (the UNet's dtype). XLA fuses gelu and the gated
    product in fp32 and rounds once; torch rounds gelu(gate) and the
    product separately, so the outputs differ by a few bf16 ulps: four
    ulps (2^-5) of the largest output magnitude."""
    p = _params(3, 32, scale=0.2)
    jp = {"geglu": {"w": jnp.asarray(p["w1"], jnp.bfloat16),
                    "b": jnp.asarray(p["b1"], jnp.bfloat16)},
          "ff_out": {"w": jnp.asarray(p["w2"], jnp.bfloat16),
                     "b": jnp.asarray(p["b2"], jnp.bfloat16)}}
    want = np.asarray(junet._geglu_ff(jp, jnp.asarray(p["x"], jnp.bfloat16))
                      .astype(jnp.float32))
    got = tgeglu.geglu_ff(*_torch_args(p, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2.0 ** -5 * np.abs(want).max(), err


@pytest.mark.parametrize("m,d,block_m,block_n", [(64, 32, 32, 64),
                                                 (96, 32, 32, 128)])
def test_geglu_ref_matches_pallas_interpret(m, d, block_m, block_n):
    p = _params(m + d, d)
    p["x"] = p["x"].reshape(-1, d)[:m]
    p["x"] = np.concatenate([p["x"]] * (m // p["x"].shape[0] + 1))[:m]
    with pltpu.force_tpu_interpret_mode():
        want = pallas_geglu_ff(*(jnp.asarray(p[k]) for k in
                                 ("x", "w1", "b1", "w2", "b2")),
                               block_m=block_m, block_n=block_n)
    got = tgeglu.geglu_ff(*_torch_args(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=2e-3)
