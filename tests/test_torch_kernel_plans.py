"""K1 and K3 of the port on the CPU: their plain versions against the
Pallas kernels of gill_tpu in interpret mode at the head dims and row
counts the redesigned kernels take (flash attention at head dims 160 and
512, the GEGLU feed-forward at a ragged row count), and the launch plans
(`flash_plan`, `geglu_plan`, `geglu_ln_splits`) the CUDA wrappers follow.
The kernels themselves are held to these plain versions on a card in
test_torch_kernels.py.

Tolerances: fp32 2e-5 (online vs one-pass softmax, another summation
order; as test_torch_attention.py); bf16 attention 2^-7 relative + 4e-3
absolute (one bf16 ulp of outputs ~1); the GEGLU 2e-3 (the Pallas kernel's
tanh-form gelu differs from erf by < 3.2e-4 an element, as
test_torch_geglu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gill_tpu.ops import attention as jattn
from gill_tpu.ops.geglu import geglu_ff as pallas_geglu_ff
from gill_tpu_torch.ops import attention as tattn
from gill_tpu_torch.ops import geglu as tgeglu

torch.backends.cuda.matmul.allow_tf32 = False


def _qkv(seed, b, t, s, h, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, h, d).astype(np.float32),
            rng.randn(b, s, h, d).astype(np.float32),
            rng.randn(b, s, h, d).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,t,s", [(160, 64, 64), (512, 40, 72)])
def test_flash_ref_matches_pallas_interpret_wide_heads(d, t, s, causal):
    """The UNet's (160) and the VAE's (512) head dims, fp32."""
    q, k, v = _qkv(d + t, 1, t, s, 2, d)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     block_q=64, block_k=64)
    got = tattn.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("d,s", [(160, 77), (512, 64)])
def test_flash_ref_bf16_matches_pallas_interpret_wide_heads(d, s):
    """bf16 at head dims 160 (77-key cross-attention) and 512."""
    q, k, v = _qkv(d + s, 2, 64, s, 1, d)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.flash_attention(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
            causal=False, block_q=64, block_k=128)
    got = tattn.flash_attention(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=4e-3, rtol=2.0 ** -7)


@pytest.mark.parametrize("m", [77, 130])
def test_geglu_ref_matches_pallas_interpret_ragged_rows(m):
    """A row count no block divides: the Pallas kernel pads its last row
    block, the plain version takes the rows as they are."""
    d = 32
    rng = np.random.RandomState(m)
    p = {"x": rng.randn(m, d), "w1": 0.05 * rng.randn(d, 8 * d),
         "b1": 0.05 * rng.randn(8 * d), "w2": 0.05 * rng.randn(4 * d, d),
         "b2": 0.05 * rng.randn(d)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    keys = ("x", "w1", "b1", "w2", "b2")
    with pltpu.force_tpu_interpret_mode():
        want = pallas_geglu_ff(*(jnp.asarray(p[k]) for k in keys),
                               block_m=32, block_n=64)
    got = tgeglu.geglu_ff(*(torch.from_numpy(p[k]) for k in keys))
    assert got.shape == (m, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=2e-3)


# (B, T, H, D, dtype) of every K1 call of the main path, and the plan each
# takes: (route, kernel head dim, query rows, keys, warps a strip, blocks)
BF, F32 = torch.bfloat16, torch.float32
K1_PLANS = [
    ((1, 257, 16, 64, F32), ("fp32", 64, 32, 32, 1, 144)),        # CLIP
    ((1, 320, 32, 128, F32), ("fp32", 128, 32, 32, 1, 320)),      # prefill
    ((1, 320, 32, 128, BF), ("mma", 128, 64, 64, 1, 160)),        # W8 serving
    ((2, 256, 8, 160, BF), ("mma", 160, 64, 64, 1, 64)),          # UNet 16²
    ((2, 64, 8, 160, BF), ("mma", 160, 64, 64, 1, 16)),           # UNet 8²
    ((1, 4096, 1, 512, BF), ("mma", 512, 32, 32, 4, 128)),        # VAE
]


@pytest.mark.parametrize("shape,want", K1_PLANS)
def test_flash_plan_at_main_path_shapes(shape, want):
    b, t, h, d, dtype = shape
    plan = tattn.flash_plan(dtype, b, t, h, d)
    assert plan.kernel == "K1"
    assert (plan.route, plan.dk, plan.bq, plan.bk, plan.ws,
            plan.blocks) == want
    # 16 query rows a warp: WS warps share each 16-row strip
    assert plan.blocks * plan.bq >= b * h * t


def test_flash_plan_fills_the_card_where_the_shape_allows():
    """The fp32 plans put at least 132 blocks on the card (one warp each 8
    rows); the VAE's 4096 rows go out as 128 blocks of eight warps, one
    block an SM by shared memory."""
    for b, t, h, d in ((1, 257, 16, 64), (1, 320, 32, 128)):
        assert tattn.flash_plan(F32, b, t, h, d).blocks >= 132
    vae = tattn.flash_plan(BF, 1, 4096, 1, 512)
    assert vae.blocks * (vae.bq // 16) * vae.ws >= 132 * 4


@pytest.mark.parametrize("d,dk", [(8, 40), (40, 40), (48, 80), (88, 128),
                                  (128, 128), (136, 160), (168, 256),
                                  (256, 256), (264, 512), (512, 512)])
def test_flash_plan_pads_bf16_head_dims(d, dk):
    plan = tattn.flash_plan(BF, 1, 100, 2, d)
    assert plan.dk == dk and plan.route == "mma"
    assert plan.kernel == ("K2" if d <= tattn.MMA_MAX_HEAD_DIM else "K1")
    assert plan.ws == (dk // 128 if dk > 160 else 1)


@pytest.mark.parametrize("d,dk,bq", [(4, 64, 32), (64, 64, 32), (68, 96, 32),
                                     (100, 128, 32), (160, 160, 32),
                                     (200, 256, 32), (300, 512, 16)])
def test_flash_plan_pads_fp32_head_dims(d, dk, bq):
    plan = tattn.flash_plan(F32, 1, 100, 2, d)
    assert (plan.route, plan.kernel, plan.dk, plan.bq) == ("fp32", "K1", dk,
                                                          bq)


@pytest.mark.parametrize("dtype,d,kw,exc", [
    (torch.float16, 64, {}, TypeError), (F32, 513, {}, ValueError),
    (BF, 0, {}, ValueError), (BF, 160, {"block_q": 64}, ValueError),
    (F32, 64, {"block_k": 64}, ValueError),
    (BF, 40, {"block_q": 32}, ValueError)])
def test_flash_plan_refuses_what_no_kernel_takes(dtype, d, kw, exc):
    with pytest.raises(exc):
        tattn.flash_plan(dtype, 1, 64, 2, d, **kw)


def test_pad_ready_pads_and_copies_only_when_needed():
    x = torch.zeros(2, 5, 3, 40)
    assert tattn._pad_ready(x, 40, 8) is x
    assert tattn._pad_ready(x, 48, 8).shape == (2, 5, 3, 48)
    view = torch.zeros(2, 5, 3, 41)[..., :40]
    y = tattn._pad_ready(view, 40, 8)
    assert y.is_contiguous() and y is not view
    assert tattn._pad_ready(view, 40, 1) is view


# (m, d) of the UNet's GEGLU FFs at 512 x 512, CFG batch 2, ragged ones,
# and the plan: (geglu_up_wg blocks, geglu_down_wg columns a block, its
# tiles, its depth splits)
K3_PLANS = [((8192, 320), (1280, 64, 320, 1)),
            ((2048, 640), (640, 128, 80, 1)),
            ((512, 1280), (320, 128, 40, 4)),
            ((128, 1280), (80, 128, 10, 14)),
            ((77, 320), (20, 64, 5, 5)),
            ((130, 1280), (160, 128, 20, 7))]


@pytest.mark.parametrize("shape,want", K3_PLANS)
def test_geglu_plan(shape, want):
    m, d = shape
    plan = tgeglu.geglu_plan(m, d)
    assert tuple(plan) == want
    # the down GEMM's blocks reach half the SMs unless each split is down
    # to four of its 64-deep steps
    steps = 4 * d // 64
    assert plan.down_tiles * plan.splits >= 66 or plan.splits == steps // 4
    assert steps // plan.splits >= 4


def test_geglu_plan_up_gemm_fills_the_card_at_the_ops_bound_shapes():
    for m, d in ((8192, 320), (2048, 640), (512, 1280)):
        assert tgeglu.geglu_plan(m, d).up_blocks >= 132


@pytest.mark.parametrize("m,d,want", [(8192, 320, 1), (2048, 640, 2),
                                      (512, 1280, 4), (128, 1280, 16),
                                      (1, 1280, 80), (77, 320, 20)])
def test_geglu_ln_splits(m, d, want):
    """K9's inner-dimension splits: SMs // (rows / (20480 / d)) blocks,
    between 1 and the 4d / 64 chunks."""
    assert tgeglu.geglu_ln_splits(m, d) == want


@pytest.mark.parametrize("fn,args", [
    (tgeglu.geglu_plan, (512, 1024)), (tgeglu.geglu_plan, (0, 320)),
    (tgeglu.geglu_ln_splits, (512, 768))])
def test_geglu_plans_refuse_what_the_kernels_do_not_take(fn, args):
    with pytest.raises(ValueError):
        fn(*args)
