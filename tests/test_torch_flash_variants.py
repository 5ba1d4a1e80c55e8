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
        [(64, 64), (64, 64), (128, 64), (128, 128)]
