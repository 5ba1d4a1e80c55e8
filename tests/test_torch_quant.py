"""gill_tpu_torch.ops.quant and the W8A8 UNet against gill_tpu's.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: int8 weights and activations equal; weight scales within one
fp32 ulp; `int8_linear` / `int8_conv2d` int32 sums equal (both are exact
integer products) and fp32 outputs within 1e-6 relative (the same fp32
epilogue); the tiny W8A8 UNet (gill_tpu's quantized tree carried over by
weights/from_jax.py) within 1e-5 relative to the output scale in fp32 (the
float layers around the int8 products sum in another order, and a
rounding that flips one int8 activation moves the output by one scale
step); the W8A8 UNet against its own fp32 weights within 0.06 relative L2,
the bound of gill_tpu's test_quantized_tiny_unet_close_to_fp32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gill_tpu.models.sd import unet as junet
from gill_tpu.ops import quant as jq
from gill_tpu_torch import config as tcfg
from gill_tpu_torch.models.sd import unet as tunet
from gill_tpu_torch.nn.core import Init, conv_weight_from_hwio
from gill_tpu_torch.ops import quant as tq
from gill_tpu_torch.weights import from_jax
from torch_threads import one_intra_op_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_quantize_weight_matches_gill_tpu(kind):
    rng = np.random.RandomState(0)
    if kind == "linear":
        w = (0.1 * rng.randn(40, 24)).astype(np.float32)
        jwq, jws = jq.quantize_weight(jnp.asarray(w), reduce_axes=(0,))
        twq, tws = tq.quantize_weight(torch.from_numpy(w), reduce_axes=(0,))
        np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq))
    else:
        w = (0.1 * rng.randn(3, 3, 16, 24)).astype(np.float32)   # HWIO
        jwq, jws = jq.quantize_weight(jnp.asarray(w), reduce_axes=(0, 1, 2))
        twq, tws = tq.quantize_weight(
            conv_weight_from_hwio(torch.from_numpy(w)), reduce_axes=(1, 2, 3))
        np.testing.assert_array_equal(twq.permute(2, 3, 1, 0).numpy(),
                                      np.asarray(jwq))
    assert twq.dtype == torch.int8
    np.testing.assert_allclose(tws.numpy(), np.asarray(jws), rtol=2 ** -23,
                               atol=0)


def test_dynamic_quantize_scale():
    """Mirrors gill_tpu's test_dynamic_quantize_scale, plus a tie: 1.5 and
    2.5 round half to even, as jnp.round does."""
    xq, s = tq.dynamic_quantize(torch.tensor([[1.0, -254.0]]))
    assert float(s) == 2.0
    np.testing.assert_array_equal(xq.numpy(), [[0, -127]])
    x = np.array([[3.0, 5.0, -127.0, 0.4]], np.float32)
    jxq, _ = jq.dynamic_quantize(jnp.asarray(x))
    txq, _ = tq.dynamic_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))


def _int32_linear_jax(x, wq):
    xq, _ = jq.dynamic_quantize(jnp.asarray(x))
    return np.asarray(jax.lax.dot_general(
        xq, jnp.asarray(wq), (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("k,n", [(32, 48), (36, 4), (20, 13)])
def test_int8_linear_matches_gill_tpu(k, n):
    """K and N need not be multiples of 8 (conv_in's 36, conv_out's 4)."""
    rng = np.random.RandomState(k + n)
    x = rng.randn(2, 9, k).astype(np.float32)
    w = (0.1 * rng.randn(k, n)).astype(np.float32)
    b = (0.1 * rng.randn(n)).astype(np.float32)
    jwq, jws = jq.quantize_weight(jnp.asarray(w), reduce_axes=(0,))
    want = np.asarray(jq.int8_linear(jnp.asarray(x), jwq, jws, jnp.asarray(b)))
    wq = torch.from_numpy(np.asarray(jwq))
    ws = torch.from_numpy(np.asarray(jws))
    xq, _ = tq.dynamic_quantize(torch.from_numpy(x))
    sums = tq.int_mm(xq.reshape(-1, k), wq).reshape(2, 9, n)
    np.testing.assert_array_equal(sums.numpy(),
                                  _int32_linear_jax(x, np.asarray(jwq)))
    got = tq.int8_linear(torch.from_numpy(x), wq, ws, torch.from_numpy(b))
    assert got.shape == (2, 9, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("cin,cout,ks,stride,padding", [
    (16, 24, 3, 1, 1), (4, 20, 3, 1, 1), (12, 4, 3, 1, "SAME"),
    (8, 8, 3, 2, 1), (8, 16, 3, 2, "SAME"), (12, 10, 1, 1, 0),
    (6, 8, 3, 1, "VALID")])
def test_int8_conv2d_matches_gill_tpu(cin, cout, ks, stride, padding):
    """int32 sums and fp32 outputs, at 3 x 3 and 1 x 1 kernels, stride 1 and
    2, int / 'SAME' / 'VALID' padding, channel counts not multiples of 8."""
    rng = np.random.RandomState(cin * cout)
    x = rng.randn(2, 9, 8, cin).astype(np.float32)
    w = (0.1 * rng.randn(ks, ks, cin, cout)).astype(np.float32)
    b = (0.1 * rng.randn(cout)).astype(np.float32)
    jwq, jws = jq.quantize_weight(jnp.asarray(w), reduce_axes=(0, 1, 2))
    want = np.asarray(jq.int8_conv2d(jnp.asarray(x), jwq, jws, jnp.asarray(b),
                                     stride=stride, padding=padding))
    wq = conv_weight_from_hwio(torch.from_numpy(np.asarray(jwq)))
    ws = torch.from_numpy(np.asarray(jws))
    got = tq.int8_conv2d(torch.from_numpy(x), wq, ws, torch.from_numpy(b),
                         stride=stride, padding=padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    # the int32 sums alone
    xq, _ = tq.dynamic_quantize(torch.from_numpy(x))
    sums = tq.conv2d_int32(xq, wq, stride=stride, padding=padding)
    jxq, _ = jq.dynamic_quantize(jnp.asarray(x))
    pad = padding if not isinstance(padding, int) else [(padding, padding)] * 2
    jsums = np.asarray(jax.lax.conv_general_dilated(
        jxq, jwq, (stride, stride), pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.numpy(), jsums)


@functools.lru_cache(maxsize=None)
def _unet_case():
    """A tiny UNet made with the port's (fast) init, its W8A8 form made by
    the port, and both in gill_tpu's layout."""
    cfg = tcfg.tiny_unet_config()
    tp = tunet.init(Init(torch.Generator().manual_seed(3), "cpu"), cfg)
    tqp = tunet.quantize_params(tp)
    rng = np.random.RandomState(4)
    lat = rng.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(2, 7, cfg.cross_attention_dim).astype(np.float32)
    return tp, tqp, from_jax.tree_to_numpy(tqp), lat, ctx


def _keys(tree, path=()):
    if isinstance(tree, dict):
        return sorted(k for key, v in tree.items()
                      for k in _keys(v, path + (key,)))
    if isinstance(tree, list):
        return sorted(k for i, v in enumerate(tree)
                      for k in _keys(v, path + (str(i),)))
    return ["/".join(path)]


def test_quantize_params_matches_gill_tpu():
    """The same tree keys (the same skips) as gill_tpu's quantize_params;
    the same int8 values and scales at conv_in, a resnet conv and a GEGLU
    projection (the jitted gill_tpu quantizer gives the keys; its values
    are held by test_quantize_weight_matches_gill_tpu and below, eagerly,
    as gill_tpu's pipeline quantizes)."""
    tp, tqp, jqp_port, _, _ = _unet_case()
    jp = from_jax.tree_to_numpy(tp)
    assert _keys(tqp) == _keys(jax.jit(junet.quantize_params)(jp))
    blk = tqp["down"][0]["attns"][0]["block"]
    assert "w" in blk["attn1"]["q"] and "w" in tqp["time_fc1"]
    assert "w" in tqp["down"][0]["resnets"][0]["time_emb"]
    for path in (("conv_in",), ("down", 0, "resnets", 0, "conv1"),
                 ("down", 0, "attns", 0, "block", "geglu")):
        jleaf, tleaf = jp, jqp_port
        for k in path:
            jleaf, tleaf = jleaf[k], tleaf[k]
        w = jnp.asarray(jleaf["w"])
        axes = tuple(range(w.ndim - 1))
        jwq, jws = jq.quantize_weight(w, reduce_axes=axes)
        np.testing.assert_array_equal(tleaf["wq"], np.asarray(jwq))
        np.testing.assert_allclose(tleaf["ws"], np.asarray(jws),
                                   rtol=2 ** -23, atol=0)


def test_tiny_w8a8_unet_matches_gill_tpu():
    """gill_tpu's params -> gill_tpu's quantize_params -> from_jax: the same
    quantized tree through gill_tpu's unet.apply and the port's, 1e-5
    relative to the output scale in fp32. (The jitted quantizer is used
    for speed; it may round a weight differently from the eager one, which
    does not matter here: both packages run the same quantized tree.)"""
    tp, _, _, lat, ctx = _unet_case()
    cfg = junet.tiny_unet_config()
    jqp = jax.device_get(jax.jit(junet.quantize_params)(
        from_jax.tree_to_numpy(tp)))
    want = jax.jit(functools.partial(junet.apply, cfg=cfg))(
        jqp, latents=jnp.asarray(lat), timesteps=jnp.asarray(500.0),
        encoder_hidden_states=jnp.asarray(ctx))
    tqp = from_jax.unet_from_jax(jqp)
    assert tqp["conv_in"]["wq"].dtype == torch.int8
    got = tunet.apply(tqp, tcfg.tiny_unet_config(), torch.from_numpy(lat),
                      torch.tensor(500.0), torch.from_numpy(ctx))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # the layout maps invert: the port's own quantized tree round-trips
    _, port_qp, port_np, _, _ = _unet_case()
    assert torch.equal(from_jax.unet_from_jax(port_np)["conv_in"]["wq"],
                       port_qp["conv_in"]["wq"])


def test_quantized_tiny_unet_close_to_fp32():
    """Mirrors gill_tpu's test_quantized_tiny_unet_close_to_fp32 on the
    port alone: relative L2 under 0.06."""
    tp, tqp, _, lat, ctx = _unet_case()
    args = (tcfg.tiny_unet_config(), torch.from_numpy(lat),
            torch.full((2,), 500), torch.from_numpy(ctx))
    ref = tunet.apply(tp, *args)
    out = tunet.apply(tqp, *args)
    rel = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
    assert rel < 0.06, rel
