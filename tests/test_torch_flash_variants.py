"""S2 and S3: the plain versions of the attention sweep's flash variants
(gill_tpu_torch/ops/flash_variants.py) against scripts/attn_sweep.py's
Pallas kernels `make_flash` and `make_flash_nomax`, run in interpret mode
on the CPU (the test swaps `pallas_call` for its interpret form while it
runs; nothing in scripts/ changes).

Tolerance: two bf16 ulps of the largest |output|. Both sides compute fp32
scores of the same bf16 values and round one fp32 quotient to bf16 at the
end; their sums run in another order, and `jnp.exp` and `torch.exp` of a
bf16 argument (the bf16-probability variants) may round differently by one
bf16 ulp.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from test_torch_mm_probe import load_script

from gill_tpu_torch.ops import flash_variants as fv
from gill_tpu_torch.scripts import attn_sweep

B, S, H, D = 1, 256, 2, 40


@pytest.fixture()
def sweep(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return load_script("attn_sweep")


def _qkv(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((B, S, H, D)).astype(np.float32) * scale
          for _ in range(3)]
    return ([jnp.asarray(x, jnp.bfloat16) for x in xs],
            [torch.from_numpy(x).to(torch.bfloat16) for x in xs])


def _close(got, want):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 2 * 2.0 ** -7 * np.abs(want).max(), err


@pytest.mark.parametrize("block_q,block_k,probs,kt", [
    (64, S, "float32", False),      # single-pass
    (128, S, "float32", False),
    (64, 64, "float32", False),     # online, rescale every 64 keys
    (64, 128, "float32", False),
    (128, S, "bfloat16", False),    # bf16 probabilities, single-pass
    (64, 128, "bfloat16", False),   # bf16 probabilities, online
    (64, S, "float32", True),       # k transposed
    (64, 128, "float32", True)])
def test_flash_variant_matches_pallas(sweep, block_q, block_k, probs, kt):
    (jq, jk, jv), (tq, tk, tv) = _qkv(block_q + block_k)
    want = sweep.make_flash(block_q, block_k, getattr(jnp, probs), kt)(
        jq, jk, jv)
    got = fv.flash_variant(tq, tk, tv, block_q=block_q, block_k=block_k,
                           prob_dtype=getattr(torch, probs), kt=kt)
    assert got.dtype == torch.bfloat16
    _close(got, want)


@pytest.mark.parametrize("block_q,block_k", [(64, S), (128, 64)])
def test_flash_nomax_matches_pallas(sweep, block_q, block_k):
    (jq, jk, jv), (tq, tk, tv) = _qkv(7 + block_k)
    want = sweep.make_flash_nomax(block_q, block_k)(jq, jk, jv)
    _close(fv.flash_nomax(tq, tk, tv, block_q=block_q, block_k=block_k),
           want)


def test_flash_nomax_keeps_the_overflow(sweep):
    """No clamp: query row 0, scaled by 100, has scores far above ~100,
    so exp(s - 12) overflows and row 0 comes out non-finite in both; the
    other rows stay finite and agree."""
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((B, S, H, D)).astype(np.float32)
          for _ in range(3)]
    xs[0][:, 0] *= 100.0
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in xs)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in xs)
    want = np.asarray(sweep.make_flash_nomax(64, S)(jq, jk, jv)
                      .astype(jnp.float32))
    got = fv.flash_nomax(tq, tk, tv, block_q=64, block_k=S).float().numpy()
    assert not np.isfinite(want[:, 0]).any()
    assert not np.isfinite(got[:, 0]).any()
    rest, got_rest = want[:, 1:], got[:, 1:]
    assert np.isfinite(rest).all() and np.isfinite(got_rest).all()
    err = np.abs(got_rest - rest).max()
    assert err <= 2 * 2.0 ** -7 * np.abs(rest).max(), err


def test_single_pass_and_online_agree():
    """The two modes compute one function: they differ only in where p
    rounds to bf16 against the running max."""
    _, (q, k, v) = _qkv(11)
    a = fv.flash_variant_ref(q, k, v, block_k=S)
    b = fv.flash_variant_ref(q, k, v, block_k=32)
    assert float((a.float() - b.float()).abs().max()) <= \
        2 * 2.0 ** -7 * float(a.float().abs().max())


def test_blocks_must_divide():
    """The Pallas grid drops a tail (num_kb = S // block_k); the port
    raises instead."""
    _, (q, k, v) = _qkv(0)
    with pytest.raises(ValueError):
        fv.flash_variant(q, k, v, block_q=64, block_k=96)
    with pytest.raises(ValueError):
        fv.flash_nomax(q, k, v, block_q=96, block_k=S)


@pytest.mark.parametrize("d", [44, 64, 80])
def test_head_dim_out_of_scope_raises(d):
    """The kernel's scope (D a multiple of 8, at most 48) holds on the CPU
    too, so a call that the card would refuse fails here first."""
    x = torch.zeros(1, 64, 1, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fv.flash_variant(x, x, x, block_q=64, block_k=64)
    with pytest.raises(ValueError):
        fv.flash_nomax(x, x, x, block_q=64, block_k=64)


def test_hopper_tiles():
    assert [fv.hopper_tile(b) for b in (64, 256, 512, 1024)] == \
        [(64, 64), (64, 64), (128, 64), (64, 128)]


def _mode(spec, s):
    """(mode, block_q, bf16 probabilities, kt) of an attn_sweep.VARIANTS
    entry at key length s."""
    _, _, _, probs, kt, nomax = spec
    _, bq, bk = attn_sweep.build(spec, s)
    mode = fv.NOMAX if nomax else fv.SINGLE if bk == s else fv.ONLINE
    return mode, bq, probs == "bfloat16", kt


@pytest.mark.parametrize("shape", [attn_sweep.SHAPE, (B, S, H, D),
                                   (2, 128, 3, 48), (1, 64, 1, 16)])
@pytest.mark.parametrize("spec", attn_sweep.VARIANTS,
                         ids=[v[0] for v in attn_sweep.VARIANTS])
def test_variant_plan_launches_every_sweep_variant(spec, shape):
    """At the sweep's shape and the tests' small ones: the tile of the
    variant's block_q, Q K^T's depth as D / 16 k16 steps and a k8 step,
    a two-stage ring, shared memory within the H100's 227 KB a block (and
    within two blocks an SM), the grid covering every query row of every
    (b, h) within the grid's limits."""
    b, s, h, d = shape
    mode, bq, bf16_probs, kt = _mode(spec, s)
    p = fv.variant_plan(b, s, s, h, d, mode, bf16_probs, kt, bq)
    assert (p.bq, p.bk) == fv.hopper_tile(bq)
    assert 16 * p.k16 + 8 * p.k8 == d and p.stages == 2
    assert 0 < 2 * p.smem <= fv.MAX_SMEM
    assert p.grid == (-(-s // p.bq), b * h)
    assert p.grid[0] * p.bq >= s and p.grid[1] <= fv.MAX_GRID_Y


@pytest.mark.parametrize("kt", [False, True])
@pytest.mark.parametrize("d", [8, 16, 24, 32, 40, 48])
def test_variant_plan_ends_in_k8_when_d_over_8_is_odd(d, kt):
    """D 8, 24 and 40 are an odd number of 16-byte chunks: Q K^T ends in
    one m16n8k8 step and nothing is zero-padded; the K tile holds D rows
    with kt (keys contiguous), BK rows of D otherwise."""
    p = fv.variant_plan(1, 1024, 256, 2, d, fv.SINGLE, False, kt, 1024)
    assert p.k16 == d // 16 and p.k8 == ((d // 8) % 2 == 1)
    nc = d // 8
    odd = lambda n: n | 1  # noqa: E731
    k_tile = d * odd(p.bk // 8) * 16 if kt else p.bk * odd(nc) * 16
    v_slot = max(k_tile, p.bk * odd(nc) * 16)
    assert p.smem == p.bq * odd(nc) * 16 + p.stages * (k_tile + v_slot)


@pytest.mark.parametrize("t,s,d,block_q,block_k,mode,probs,kt", [
    (256, 256, 44, 64, 256, fv.SINGLE, False, False),    # D not 8k
    (256, 256, 56, 64, 256, fv.SINGLE, False, False),    # D past 48
    (256, 256, 40, 96, 256, fv.SINGLE, False, False),    # T % block_q
    (256, 256, 40, 0, 256, fv.SINGLE, False, False),
    (256, 256, 40, 64, 256, fv.NOMAX, True, False),      # S3: fp32 only
    (256, 256, 40, 64, 256, fv.NOMAX, False, True),      # S3: no kt
    (256, 252, 40, 64, 252, fv.SINGLE, False, True),     # kt: S % 8
    (256, 256, 40, 64, 256, 3, False, False)])           # no such mode
def test_variant_plan_refuses_what_the_kernel_does_not_take(
        t, s, d, block_q, block_k, mode, probs, kt):
    """Every call `_check` or the launch refuses, the plan refuses too (so
    the C side, which checks the plan, never sees it)."""
    with pytest.raises(ValueError):
        fv.variant_plan(1, t, s, 2, d, mode, probs, kt, block_q)
    x = torch.zeros(1, t, 2, d, dtype=torch.bfloat16)
    y = torch.zeros(1, s, 2, d, dtype=torch.bfloat16)
    if mode == fv.SINGLE and not kt:
        with pytest.raises(ValueError):
            fv.flash_variant(x, y, y, block_q=block_q, block_k=block_k)


def test_variant_plan_refuses_too_many_heads():
    with pytest.raises(ValueError):
        fv.variant_plan(2, 64, 64, fv.MAX_GRID_Y, 40, fv.ONLINE, False,
                        False, 64)
    assert fv.variant_plan(1, 64, 64, fv.MAX_GRID_Y, 40, fv.ONLINE, False,
                           False, 64).grid == (1, fv.MAX_GRID_Y)
