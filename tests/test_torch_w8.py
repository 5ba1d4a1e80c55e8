"""W8A16 serving pieces of gill_tpu_torch against gill_tpu: the W8 matmul's
plain version against the Pallas kernels (run in interpret mode, as
tests/test_opt.py runs them), quantize_params_w8, the quantized-tree
carry-over, and the OPT forward / cached decode on W8 parameters.

Tolerances: fp32 outputs 2e-4 (the Pallas tests' own bound: both sides
sum fp32 products in another order); bf16 outputs one bf16 ulp of the
largest output (both sides round one fp32 value to bf16, so a sum that
lands near a rounding boundary may round the other way); scales within one
fp32 ulp (XLA may divide by 127 as a multiply by its reciprocal); W8 model
logits 1e-5 relative to the output scale (both sides run the dequant form,
fp32 sums in another order).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gill_tpu.config import OPTConfig
from gill_tpu.models import opt as jopt
from gill_tpu.ops.w8_matmul import w8_matmul as jw8_matmul
from gill_tpu.ops.w8_matmul import w8_matmul_stacked as jw8_stacked
from gill_tpu_torch import config as tcfg
from gill_tpu_torch.models import opt as topt
from gill_tpu_torch.nn import core as tnn
from gill_tpu_torch.ops.w8_matmul import (w8_matmul, w8_matmul_ref,
                                          w8_matmul_stacked)
from gill_tpu_torch.weights import from_jax

BF16_ULP = 2.0 ** -7


def _operands(rng, m, k, n, lead=()):
    x = rng.randn(m, k).astype(np.float32)
    w8 = rng.randint(-127, 128, lead + (k, n)).astype(np.int8)
    ws = (np.abs(rng.randn(n)) * 1e-3 + 1e-4).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    return x, w8, ws, b


def _assert_out(got, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        top = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= BF16_ULP * top


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8_matmul_plain_matches_pallas(dtype):
    """test_opt.py::test_w8_matmul_kernel_matches_xla's shapes."""
    x, w8, ws, b = _operands(np.random.RandomState(0), 16, 1024, 1024)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jw8_matmul(jnp.asarray(x, jdt), jnp.asarray(w8),
                          jnp.asarray(ws), jnp.asarray(b),
                          block_n=512, block_k=512)
    tx = torch.from_numpy(x).to(tdt)
    got = w8_matmul(tx, torch.from_numpy(w8), torch.from_numpy(ws),
                    torch.from_numpy(b))
    assert got.dtype == tdt and tuple(got.shape) == (16, 1024)
    _assert_out(got, want, dtype)
    # a CPU tensor takes the plain version itself
    torch.testing.assert_close(got, w8_matmul_ref(
        tx, torch.from_numpy(w8), torch.from_numpy(ws), torch.from_numpy(b)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8_matmul_stacked_plain_matches_pallas(dtype):
    """test_opt.py::test_w8_matmul_stacked_matches_xla: every layer of an
    (L, K, N) stack, the port on the view w8[i]."""
    rng = np.random.RandomState(1)
    x, w8, _, _ = _operands(rng, 8, 1024, 512, lead=(3,))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tw8 = torch.from_numpy(w8)
    for i in range(3):
        ws = (np.abs(rng.randn(512)) * 1e-3 + 1e-4).astype(np.float32)
        b = rng.randn(512).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            want = jw8_stacked(jnp.asarray(x, jdt), jnp.asarray(w8),
                               jnp.asarray(ws), jnp.asarray(b), i,
                               block_n=256, block_k=512)
        got = w8_matmul_stacked(torch.from_numpy(x).to(tdt), tw8,
                                torch.from_numpy(ws), torch.from_numpy(b), i)
        _assert_out(got, want, dtype)


def test_w8_matmul_without_bias_and_leading_dims():
    x, w8, ws, _ = _operands(np.random.RandomState(2), 6, 512, 512)
    with pltpu.force_tpu_interpret_mode():
        want = jw8_matmul(jnp.asarray(x).reshape(2, 3, 512), jnp.asarray(w8),
                          jnp.asarray(ws), None)
    got = w8_matmul(torch.from_numpy(x).reshape(2, 3, 512),
                    torch.from_numpy(w8), torch.from_numpy(ws))
    assert tuple(got.shape) == (2, 3, 512)
    _assert_out(got, want, "float32")


CFG = OPTConfig(num_layers=2, hidden_size=64, ffn_dim=128, num_heads=4,
                vocab_size=100, max_positions=32, word_embed_proj_dim=64)
TCFG = tcfg.OPTConfig(**CFG.__dict__)


@pytest.fixture(scope="module")
def w8_trees():
    p = jax.device_get(jopt.init(jax.random.PRNGKey(3), CFG))
    jq = jax.device_get(jopt.quantize_params_w8(p))
    return p, jq


@pytest.mark.parametrize("kernel", [None, True, False])
def test_quantize_params_w8_matches_gill_tpu(w8_trees, kernel):
    p, _ = w8_trees
    jq = jax.device_get(jopt.quantize_params_w8(p, kernel=kernel))
    tq = topt.quantize_params_w8(from_jax.opt_from_jax(p), kernel=kernel)
    for name in ("q", "k", "v", "o", "fc1", "fc2"):
        jl = jq["layers"]["attn"][name] if name in "qkvo" \
            else jq["layers"][name]
        tl = tq["layers"]["attn"][name] if name in "qkvo" \
            else tq["layers"][name]
        assert tl["w8"].dtype == torch.int8 and tl["ws"].dtype == torch.float32
        np.testing.assert_array_equal(tl["w8"].numpy(), jl["w8"])
        ws = np.asarray(jl["ws"])
        assert np.all(np.abs(tl["ws"].numpy() - ws) <= np.spacing(ws))
        np.testing.assert_array_equal(tl["b"].numpy(), jl["b"])
        assert sorted(k for k in tl if k in ("kern", "xla")) == \
            sorted(k for k in jl if k in ("kern", "xla"))
        assert "w" not in tl
    # norms and embeddings stay as they were
    np.testing.assert_array_equal(tq["embed_tokens"]["weight"].numpy(),
                                  p["embed_tokens"]["weight"])


def test_from_jax_carries_quantized_lm_tree(w8_trees):
    """int8 w8 (L, K, N), fp32 ws (L, N), b, and the empty-tuple markers;
    the scales stay fp32 even when the tree is cast."""
    p, _ = w8_trees
    jq = jax.device_get(jopt.quantize_params_w8(p, kernel=True))
    tq = from_jax.opt_from_jax(jq, dtype=torch.bfloat16)
    leaf = tq["layers"]["fc1"]
    assert leaf["w8"].dtype == torch.int8
    assert tuple(leaf["w8"].shape) == (2, 64, 128)
    assert leaf["ws"].dtype == torch.float32 and tuple(leaf["ws"].shape) == (2, 128)
    assert leaf["b"].dtype == torch.bfloat16
    assert leaf["kern"] == ()
    np.testing.assert_array_equal(leaf["w8"].numpy(), jq["layers"]["fc1"]["w8"])
    xla = from_jax.opt_from_jax(jax.device_get(
        jopt.quantize_params_w8(p, kernel=False)))
    assert xla["layers"]["attn"]["q"]["xla"] == ()


def test_linear_w8_leaf_is_the_dequant_form_on_cpu(w8_trees):
    """On the CPU a W8 leaf takes gill_tpu's dequant form x @ (w8 * ws) + b,
    which equals the kernel's arithmetic up to fp32 rounding."""
    _, jq = w8_trees
    tq = from_jax.opt_from_jax(jq)
    leaf = tnn.layer_view(tq["layers"]["fc1"], 1)
    x = torch.from_numpy(np.random.RandomState(4).randn(5, 64)
                         .astype(np.float32))
    got = tnn.linear(leaf, x)
    jleaf = {"w8": jq["layers"]["fc1"]["w8"][1], "ws": jq["layers"]["fc1"]["ws"][1],
             "b": jq["layers"]["fc1"]["b"][1]}
    from gill_tpu.nn import core as jnn

    want = np.asarray(jnn.linear(jleaf, jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    ref = w8_matmul_ref(x, leaf["w8"], leaf["ws"], leaf["b"])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_opt_w8_forward_and_cached_greedy_match_gill_tpu(w8_trees):
    """The W8 LM's full forward logits, and a prefill + 6 greedy decode
    steps over the in-place cache: logits within 1e-5 of the output scale,
    greedy tokens equal."""
    _, jq = w8_trees
    tq = from_jax.opt_from_jax(jq)
    ids = np.array([[2, 5, 9, 30, 60, 7, 11, 42]])
    want = jopt.forward(jq, CFG, jopt.embed_tokens(jq, jnp.asarray(ids)))
    got = topt.forward(tq, TCFG, topt.embed_tokens(tq, torch.from_numpy(ids)))
    scale = float(np.abs(np.asarray(want["logits"])).max())
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]),
                               atol=1e-5 * max(1.0, scale), rtol=1e-5)

    jcache = jopt.init_cache(CFG, 1, 16, dtype=jnp.float32)
    tcache = topt.init_cache(TCFG, 1, 16, device="cpu", dtype=torch.float32)
    jout = jopt.forward(jq, CFG, jopt.embed_tokens(jq, jnp.asarray(ids[:, :5])),
                        cache=jcache, cache_pos=0)
    tout = topt.forward(tq, TCFG, topt.embed_tokens(tq, torch.from_numpy(
        ids[:, :5])), cache=tcache, cache_pos=0)
    jtok = int(jnp.argmax(jout["logits"][0, -1]))
    ttok = int(tout["logits"][0, -1].argmax())
    jtoks, ttoks = [jtok], [ttok]
    jcache = jout["cache"]
    for pos in range(5, 11):
        jout = jopt.forward(jq, CFG, jopt.embed_tokens(
            jq, jnp.asarray([[jtok]])), cache=jcache,
            cache_pos=jnp.asarray(pos))
        jcache = jout["cache"]
        tout = topt.forward(tq, TCFG, topt.embed_tokens(
            tq, torch.tensor([[ttok]])), cache=tcache, cache_pos=pos)
        np.testing.assert_allclose(tout["logits"].numpy(),
                                   np.asarray(jout["logits"]), rtol=1e-5,
                                   atol=1e-5 * max(1.0, scale))
        jtok = int(jnp.argmax(jout["logits"][0, -1]))
        ttok = int(tout["logits"][0, -1].argmax())
        jtoks.append(jtok)
        ttoks.append(ttok)
    assert ttoks == jtoks


def test_load_gill_defaults_to_the_card():
    """The port's entry points run on CUDA unless the caller asks for the
    CPU (the tests pass device="cpu")."""
    from gill_tpu_torch.api import load_gill

    params = inspect.signature(load_gill).parameters
    assert params["device"].default == "cuda"
    assert params["lm_weight_precision"].default == "bf16"
    assert params["kv_cache_precision"].default == "bf16"
