"""K4/K5, the W8A16 matmul, on the CPU: its launch plan `w8_plan` (the
geometry csrc/w8_matmul.cu takes, which the card tests hold against the C
side) at the serving shapes `chip_smoke.py` times, its refusals, and
`w8_matmul(..., block_n=, block_k=)` against gill_tpu's Pallas kernel with
the same block arguments in interpret mode (on the CPU the arguments change
nothing; on the card they pick the strip width and the stage depth).

Tolerances as tests/test_torch_w8.py: fp32 2e-4 (fp32 sums in another
order), bf16 one bf16 ulp of the largest output (one rounding of the same
fp32 value, sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import W8_SHAPES
from gill_tpu.ops.w8_matmul import w8_matmul as jw8_matmul
from gill_tpu_torch.ops.w8_matmul import (BLOCK_KS, BLOCK_NS, H100_SMS,
                                          w8_matmul, w8_matmul_ref, w8_plan)

BF16_ULP = 2.0 ** -7


@pytest.mark.parametrize("site,m,k,n,dtype", W8_SHAPES)
def test_w8_plan_at_the_serving_shapes(site, m, k, n, dtype):
    """At every bf16 decode shape >= 128 blocks for the 132 SMs (in one
    launch, which the card tests count); the strip divides N, the stage
    and its splits divide K, the row tile covers the decode rows."""
    p = w8_plan(m, k, n, dtype)
    assert p.route == ("fma" if dtype == "float32" else "mma")
    assert n % p.block_n == 0 and k % (p.block_k * p.splits) == 0
    assert 1 <= p.splits <= 8 and 2 <= p.stages <= 8
    assert p.blocks == p.splits * (n // p.block_n) * -(-m // p.row_tile)
    if site.startswith("decode"):
        assert p.blocks >= 128 and p.row_tile >= m
    assert p.blocks <= 4 * H100_SMS


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", [1, 7, 8, 9, 16, 17, 64, 255, 256])
def test_w8_plan_takes_every_row_count_and_block(m, dtype):
    """Every accepted (block_n, block_k) keeps those invariants, at the
    row tile of its route; the ring fits the card's 227 KB of shared
    memory."""
    accepted = 0
    for bn in BLOCK_NS:
        for bk in BLOCK_KS:
            try:
                p = w8_plan(m, 4096, 4096, dtype, block_n=bn, block_k=bk)
            except ValueError:
                continue
            accepted += 1
            assert (p.block_n, p.block_k) == (bn, bk)
            assert 4096 % (bk * p.splits) == 0
            assert p.row_tile == ((1 if m == 1 else 4) if dtype == "float32"
                                  else 8 if m <= 8 else 16 if m <= 16
                                  else 128)
            esize = 4 if dtype == "float32" else 2
            stage = -(-(bk * bn + p.row_tile * bk * esize) // 1024) * 1024
            assert 1024 + p.stages * stage <= 227 * 1024
    # fp32: 128-column strips only; bf16 at M <= 16: stages of >= 128 rows
    assert accepted == (3 if dtype == "float32" else 4 if m <= 16 else 6)


@pytest.mark.parametrize("args,exc", [
    ((0, 4096, 4096, "bfloat16"), ValueError),           # no rows
    ((257, 4096, 4096, "bfloat16"), ValueError),         # M > 256
    ((16, 4000, 4096, "bfloat16"), ValueError),          # K % 512
    ((16, 4096, 1000, "bfloat16"), ValueError),          # N % 512
    ((16, 4096, 4096, "float16"), TypeError),            # x dtype
])
def test_w8_plan_refuses_what_the_kernel_does_not_take(args, exc):
    with pytest.raises(exc):
        w8_plan(*args)


@pytest.mark.parametrize("m,dtype,kw", [
    (16, "bfloat16", dict(block_n=32)),                  # not a strip width
    (16, "bfloat16", dict(block_n=512)),                 # gill_tpu's default
    (1, "float32", dict(block_n=64)),                    # fp32: 128 only
    (16, "bfloat16", dict(block_k=512)),                 # not a stage depth
    (16, "bfloat16", dict(block_k=100)),                 # does not divide K
    (16, "bfloat16", dict(block_k=64)),                  # < 16 rows a warp
])
def test_w8_plan_refuses_block_sizes_the_kernel_does_not_take(m, dtype, kw):
    with pytest.raises(ValueError):
        w8_plan(m, 4096, 4096, dtype, **kw)
    x = torch.zeros(m, 4096, dtype=getattr(torch, dtype))
    with pytest.raises(ValueError):      # on the CPU as on the card
        w8_matmul(x, torch.zeros(4096, 4096, dtype=torch.int8),
                  torch.ones(4096), **kw)


@pytest.mark.parametrize("block_n,block_k,dtype", [
    (64, 128, "bfloat16"), (128, 256, "bfloat16"), (128, 64, "float32"),
    (128, 256, "float32")])
def test_w8_matmul_block_args_match_pallas_interpret(block_n, block_k,
                                                     dtype):
    """test_torch_w8.py's comparison with the block arguments given to
    both sides: gill_tpu's Pallas kernel in interpret mode at those tiles,
    the port on the CPU (its plain version)."""
    rng = np.random.RandomState(block_n + block_k)
    x = rng.randn(8, 512).astype(np.float32)
    w8 = rng.randint(-127, 128, (512, 512)).astype(np.int8)
    ws = (np.abs(rng.randn(512)) * 1e-3 + 1e-4).astype(np.float32)
    b = rng.randn(512).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jw8_matmul(jnp.asarray(x, jdt), jnp.asarray(w8),
                          jnp.asarray(ws), jnp.asarray(b), block_n=block_n,
                          block_k=block_k)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tx, tw, tws, tb = (torch.from_numpy(a) for a in (x, w8, ws, b))
    got = w8_matmul(tx.to(tdt), tw, tws, tb, block_n=block_n,
                    block_k=block_k)
    assert got.dtype == tdt and tuple(got.shape) == (8, 512)
    torch.testing.assert_close(got, w8_matmul_ref(tx.to(tdt), tw, tws, tb))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    else:
        top = float(np.abs(want).max())
        assert float(np.abs(got.float().numpy() - want).max()) \
            <= BF16_ULP * top
