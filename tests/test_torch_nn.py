"""gill_tpu_torch.nn.core against gill_tpu.nn.core on the same numpy-seeded
inputs (the port's counterpart of test_nn_torch_parity.py).

Tolerances: fp32 paths agree to float rounding of sums taken in another
order (<= 3e-5 at these sizes); bf16 paths to one bf16 ulp of the output
(2^-7 relative; the reductions are fp32 on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gill_tpu.nn import core as jnn
from gill_tpu_torch.nn import core as tnn
from gill_tpu_torch.weights.from_jax import tree_from_jax
from torch_threads import one_intra_op_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("stride,pad,size,k", [
    (1, 1, 16, 3), (2, 1, 16, 3), (1, 0, 8, 1), (4, 2, 16, 3),
    (8, "VALID", 16, 8), (1, "SAME", 9, 3), (2, "SAME", 9, 3),
    (2, "SAME", 8, 3)])
def test_conv2d_matches_gill_tpu(stride, pad, size, k):
    rng = np.random.RandomState(0)
    x = rng.randn(2, size, size, 5).astype(np.float32)          # NHWC
    p = {"w": rng.randn(k, k, 5, 7).astype(np.float32),         # HWIO
         "b": rng.randn(7).astype(np.float32)}
    want = jnn.conv2d(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                      stride=stride, padding=pad)
    got = tnn.conv2d(tree_from_jax(p), _t(x), stride=stride, padding=pad)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=3e-5)


@pytest.mark.parametrize("groups,eps", [(4, 1e-6), (2, 1e-5)])
def test_group_norm_matches_gill_tpu(groups, eps):
    rng = np.random.RandomState(1)
    x = (3.0 + 2.0 * rng.randn(2, 4, 4, 8)).astype(np.float32)
    p = {"scale": rng.randn(8).astype(np.float32),
         "bias": rng.randn(8).astype(np.float32)}
    want = jnn.group_norm(jax.tree_util.tree_map(jnp.asarray, p),
                          jnp.asarray(x), groups, eps=eps)
    got = tnn.group_norm(tree_from_jax(p), _t(x), groups, eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=3e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_gill_tpu(dtype):
    rng = np.random.RandomState(2)
    x = (1.0 + rng.randn(3, 5, 32)).astype(np.float32)
    p = {"scale": rng.randn(32).astype(np.float32),
         "bias": rng.randn(32).astype(np.float32)}
    want = jnn.layer_norm(jax.tree_util.tree_map(jnp.asarray, p),
                          jnp.asarray(x, dtype), 1e-5)
    got = tnn.layer_norm(tree_from_jax(p), _t(x).to(getattr(torch, dtype)),
                         1e-5)
    assert str(got.dtype) == f"torch.{dtype}"
    tol = 3e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol * 4, rtol=tol)


@pytest.mark.parametrize("x_dtype,w_dtype", [("float32", "float32"),
                                             ("float32", "bfloat16"),
                                             ("bfloat16", "bfloat16")])
def test_linear_casts_weight_to_activation_dtype(x_dtype, w_dtype):
    """nn.linear casts w (and b) to x's dtype: bf16 weights under fp32
    activations compute in fp32, the main path's LM/CLIP regime."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 16).astype(np.float32)
    p = {"w": rng.randn(16, 8).astype(np.float32),
         "b": rng.randn(8).astype(np.float32)}
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, w_dtype), p)
    want = jnn.linear(jp, jnp.asarray(x, x_dtype))
    got = tnn.linear(tree_from_jax(jax.device_get(jp)),
                     _t(x).to(getattr(torch, x_dtype)))
    assert str(got.dtype) == f"torch.{x_dtype}"
    tol = 1e-5 if x_dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol * 8, rtol=tol)


@pytest.mark.parametrize("ctx_len", [None, 6])
def test_mha_apply_matches_gill_tpu(ctx_len):
    rng = np.random.RandomState(4)
    p = jax.device_get(jnn.mha_init(jax.random.PRNGKey(0), 16, 4))
    x = rng.randn(2, 5, 16).astype(np.float32)
    ctx = None if ctx_len is None else rng.randn(2, ctx_len, 16).astype(
        np.float32)
    want = jnn.mha_apply(jax.tree_util.tree_map(jnp.asarray, p),
                         jnp.asarray(x),
                         None if ctx is None else jnp.asarray(ctx),
                         num_heads=4)
    got = tnn.mha_apply(tree_from_jax(p), _t(x),
                        None if ctx is None else _t(ctx), num_heads=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_init_distributions_follow_gill_tpu():
    """Random init draws from gill_tpu's distributions: kaiming-uniform
    fan-in bounds for linear/conv, N(0, 0.02) embeddings, unit norms."""
    g = torch.Generator().manual_seed(0)
    init = tnn.Init(g, "cpu", torch.float32)
    lin = init.linear(64, 512, lead=(3,))
    assert lin["w"].shape == (3, 64, 512) and lin["b"].shape == (3, 512)
    assert float(lin["w"].abs().max()) <= 1 / 8
    assert abs(float(lin["w"].std()) - (1 / 8) / np.sqrt(3)) < 2e-3
    conv = init.conv2d(4, 6, 3)
    assert conv["w"].shape == (6, 4, 3, 3)
    assert conv["w"].is_contiguous(memory_format=torch.channels_last)
    assert float(conv["w"].abs().max()) <= 1 / 6
    emb = init.embedding(1000, 64)["weight"]
    assert abs(float(emb.std()) - 0.02) < 1e-3
    ln = init.layer_norm(8)
    assert torch.equal(ln["scale"], torch.ones(8))
    assert torch.equal(ln["bias"], torch.zeros(8))
