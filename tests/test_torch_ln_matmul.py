"""gill_tpu_torch.ops.ln_matmul and the LN-folded GEGLU against gill_tpu's.

The plain versions `ln_matmul_ref` / `ln_matmul_stacked_ref` are held
against gill_tpu's Pallas `ln_matmul` / `ln_matmul_stacked` run in
interpret mode (as tests/test_ln_matmul.py runs them), and
`geglu_ff_ref(..., ln_gamma=...)` against gill_tpu's composed path and its
Pallas `_kernel_ln`. The CUDA kernels against these plain versions are in
test_torch_kernels.py.

Tolerances: fp32 2e-5 (test_ln_matmul.py's own: the same LayerNorm and
products, summed in another order); bf16 two bf16 ulps of the largest
output (both round one fp32 product sum to bf16 once, after the same bf16
LayerNorm roundings); the LN-folded GEGLU against the Pallas `_kernel_ln`
at the tanh-vs-erf gelu bound: |tanh-gelu - erf-gelu| < 3.2e-4 per element
(gill_tpu/ops/geglu.py:57-60), so each output may move by 3.2e-4 times
sum_j |val_j| |W2_jk|, plus 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gill_tpu.models.sd import unet as junet
from gill_tpu.ops.geglu import geglu_ff as pallas_geglu_ff
from gill_tpu.ops.ln_matmul import ln_matmul as pallas_ln_matmul
from gill_tpu.ops.ln_matmul import ln_matmul_stacked as pallas_ln_stacked
from gill_tpu_torch.ops import geglu as tgeglu
from gill_tpu_torch.ops import ln_matmul as tln
from torch_threads import one_intra_op_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False


def _case(seed, m, d, n, k=None):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, m // 2, d) * 2.0 + 0.3).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    beta = (0.1 * rng.randn(d)).astype(np.float32)
    wshape = (d, n) if k is None else (k, d, n)
    w = (0.05 * rng.randn(*wshape)).astype(np.float32)
    return x, gamma, beta, w


def _t(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


@pytest.mark.parametrize("m,d,n,block_m,block_n",
                         [(64, 32, 96, 32, 96), (96, 64, 256, 32, 128),
                          (130, 32, 64, 64, 64)])
def test_ln_matmul_ref_matches_pallas_interpret(m, d, n, block_m, block_n):
    x, g, b, w = _case(m + d, m, d, n)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_ln_matmul(*(jnp.asarray(a) for a in (x, g, b, w)),
                                block_m=block_m, block_n=block_n)
    got = tln.ln_matmul(*_t(x, g, b, w))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_ln_matmul_stacked_ref_matches_pallas_interpret():
    x, g, b, ws = _case(3, 96, 32, 64, k=3)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_ln_stacked(*(jnp.asarray(a) for a in (x, g, b, ws)),
                                 block_m=32)
    got = tln.ln_matmul_stacked(*_t(x, g, b, ws))
    assert tuple(got.shape) == (3, 2, 48, 64) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    for k in range(3):
        torch.testing.assert_close(
            got[k], tln.ln_matmul_ref(*_t(x, g, b, ws[k])), atol=0, rtol=0)


@pytest.mark.parametrize("stacked", [False, True])
def test_ln_matmul_ref_bf16_matches_pallas_interpret(stacked):
    x, g, b, w = _case(5, 64, 64, 128, k=3 if stacked else None)
    fn, ref = ((pallas_ln_stacked, tln.ln_matmul_stacked) if stacked
               else (pallas_ln_matmul, tln.ln_matmul))
    with pltpu.force_tpu_interpret_mode():
        want = fn(*(jnp.asarray(a, jnp.bfloat16) for a in (x, g, b, w)),
                  block_m=32)
    got = ref(*_t(x, g, b, w, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2 * 2.0 ** -7 * np.abs(want).max(), err


def _geglu_case(seed, m, d, scale=0.05):
    rng = np.random.RandomState(seed)
    return {"x": (rng.randn(2, m // 2, d) * 1.5 - 0.2).astype(np.float32),
            "g": (1.0 + 0.1 * rng.randn(d)).astype(np.float32),
            "b": (0.1 * rng.randn(d)).astype(np.float32),
            "w1": (scale * rng.randn(d, 8 * d)).astype(np.float32),
            "b1": (scale * rng.randn(8 * d)).astype(np.float32),
            "w2": (scale * rng.randn(4 * d, d)).astype(np.float32),
            "b2": (scale * rng.randn(d)).astype(np.float32)}


def _geglu_ln(p, dtype=torch.float32):
    x, g, b, w1, b1, w2, b2 = _t(*(p[k] for k in
                                   ("x", "g", "b", "w1", "b1", "w2", "b2")),
                                 dtype=dtype)
    return tgeglu.geglu_ff(x, w1, b1, w2, b2, ln_gamma=g, ln_beta=b)


@pytest.mark.parametrize("d", [16, 32])
def test_geglu_ln_ref_matches_composed_unet_ff(d):
    """gill_tpu's composed path off-TPU: nn.layer_norm, then `_geglu_ff`
    (exact-erf gelu); fp32 2e-5."""
    p = _geglu_case(d, 48, d)
    jp = {"geglu": {"w": jnp.asarray(p["w1"]), "b": jnp.asarray(p["b1"])},
          "ff_out": {"w": jnp.asarray(p["w2"]), "b": jnp.asarray(p["b2"])}}
    ln = {"scale": jnp.asarray(p["g"]), "bias": jnp.asarray(p["b"])}
    want = junet._geglu_ff(jp, jnp.asarray(p["x"]), ln=ln)
    np.testing.assert_allclose(_geglu_ln(p).numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_geglu_ln_ref_matches_pallas_kernel_ln_interpret():
    m, d = 64, 32
    p = _geglu_case(1, m, d)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_geglu_ff(*(jnp.asarray(p[k]) for k in
                                 ("x", "w1", "b1", "w2", "b2")),
                               ln_gamma=jnp.asarray(p["g"]),
                               ln_beta=jnp.asarray(p["b"]),
                               block_m=32, block_n=64)
    got = _geglu_ln(p).numpy()
    # the bound: 3.2e-4 |val| |W2| from the tanh form of the gelu
    xn = tln.ln_rows(*_t(p["x"], p["g"], p["b"])).numpy()
    val = np.abs(xn @ p["w1"][:, :4 * d] + p["b1"][:4 * d])
    tol = 3.2e-4 * (val @ np.abs(p["w2"])) + 2e-5
    assert (np.abs(got - np.asarray(want)) <= tol).all()
