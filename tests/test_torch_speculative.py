"""gill_tpu_torch's SpeculativeDecoder (serve/speculative.py) against
gill_tpu's on the same carried-over target and draft parameters:
tests/test_speculative.py's six cases.

Both decode greedily in fp32 on the CPU. The tokens must be EXACTLY
gill_tpu's and the target's own greedy decode, for agreeing, disagreeing
and degenerate drafts, and `last_stats` (rounds run, drafts accepted, k)
must equal gill_tpu's: the port runs its rounds in the same batches of
`rounds_per_call`, syncing each round's accepted count to the host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gill_tpu.config import OPTConfig
from gill_tpu.models import opt as jopt
from gill_tpu.serve.speculative import SpeculativeDecoder as JSpec
from gill_tpu_torch import config as tcfg
from gill_tpu_torch.serve.speculative import SpeculativeDecoder
from gill_tpu_torch.weights.from_jax import opt_from_jax


def _cfg(dims=64):
    return OPTConfig(num_layers=2, hidden_size=dims, ffn_dim=128,
                     num_heads=4, vocab_size=128, max_positions=512,
                     word_embed_proj_dim=dims)


def _model(seed, dims=64):
    cfg = _cfg(dims)
    params = jax.device_get(jopt.init(jax.random.PRNGKey(seed), cfg))
    return params, cfg, opt_from_jax(params), tcfg.OPTConfig(**cfg.__dict__)


@pytest.fixture(scope="module")
def target():
    return _model(21)


@pytest.fixture(scope="module")
def drafts():
    return {"disagreeing": _model(99, 32), "other": _model(3, 32)}


@torch.no_grad()
def _target_greedy(target, prompt, n_new):
    """The target's own one-token greedy decode (the reference of
    tests/test_speculative.py), on the port's side."""
    from gill_tpu_torch.models import opt as topt

    params, cfg = target[2], target[3]
    cache = topt.init_cache(cfg, 1, 256, device="cpu", dtype=torch.float32)
    out = topt.forward(params, cfg,
                       topt.embed_tokens(params, torch.tensor([prompt])),
                       cache=cache, cache_pos=0)
    gen = [int(out["logits"][0, len(prompt) - 1].argmax())]
    for pos in range(len(prompt), len(prompt) + n_new - 1):
        out = topt.forward(params, cfg, topt.embed_tokens(
            params, torch.tensor([[gen[-1]]])), cache=cache, cache_pos=pos)
        gen.append(int(out["logits"][0, -1].argmax()))
    return gen


def _pair(target, draft, unroll=False, **kw):
    kw.setdefault("max_seq", 256)
    jdec = JSpec(target[0], target[1], draft[0], draft[1],
                 unroll_layers=unroll, kv_dtype=jnp.float32, **kw)
    tdec = SpeculativeDecoder(target[2], target[3], draft[2], draft[3],
                              kv_dtype=torch.float32, **kw)
    return jdec, tdec


def _check(target, draft, prompt, n_new, unroll=False, **kw):
    jdec, tdec = _pair(target, draft, unroll, **kw)
    want = jdec.generate(prompt, n_new)
    got = tdec.generate(prompt, n_new)
    assert got == want
    assert tdec.last_stats == jdec.last_stats
    return got, tdec


def _run(target, draft, k=4, rounds=3, n_new=17, seed=5):
    prompt = np.random.RandomState(seed).randint(2, 120, size=9).tolist()
    got, dec = _check(target, draft, prompt, n_new, k=k,
                      rounds_per_call=rounds, prefill_buckets=(16,))
    assert got == _target_greedy(target, prompt, n_new)
    return dec


def test_agreeing_draft_exact(target):
    """Draft == target: every refutable position is accepted (the k - 1
    cap binds every round)."""
    dec = _run(target, target)
    st = dec.last_stats
    assert st["accepted"] == st["rounds"] * (st["k"] - 1)


def test_disagreeing_draft_exact(target, drafts):
    """An independent random draft: rejections dominate; output unchanged."""
    dec = _run(target, drafts["disagreeing"])
    assert dec.last_stats["accepted"] < dec.last_stats["rounds"] * 3


@pytest.mark.parametrize("k,rounds,n_new,seed,draft",
                         [(2, 2, 5, 0, "other"), (6, 4, 23, 1, "other"),
                          (3, 1, 1, 2, "other"), (2, 2, 5, 0, "target"),
                          (6, 4, 23, 1, "target")])
def test_various_k_and_lengths(target, drafts, k, rounds, n_new, seed, draft):
    _run(target, target if draft == "target" else drafts[draft], k=k,
         rounds=rounds, n_new=n_new, seed=seed)


def test_eos_truncates(target):
    prompt = np.random.RandomState(7).randint(2, 120, size=6).tolist()
    free = _target_greedy(target, prompt, 12)
    eos = free[5]
    got, _ = _check(target, target, prompt, 12, k=4, prefill_buckets=(8,),
                    rounds_per_call=2, eos_id=eos)
    assert got == free[:free.index(eos) + 1]


@pytest.mark.parametrize("unroll", [True, False])
def test_unrolled_layers_matches(target, unroll):
    """gill_tpu's unroll_layers=True (its TPU default) and False against the
    port's single path (which takes the argument and ignores it)."""
    prompt = np.random.RandomState(9).randint(2, 120, size=9).tolist()
    got, _ = _check(target, target, prompt, 13, unroll=unroll, k=4,
                    prefill_buckets=(16,), rounds_per_call=3)
    assert got == _target_greedy(target, prompt, 13)


def test_prompt_longer_than_configured_buckets(target):
    """Buckets extend to max_seq: a prompt between the largest configured
    bucket and max_seq decodes; a request past max_seq with the rounds'
    slack is refused as gill_tpu refuses it."""
    prompt = np.random.RandomState(10).randint(2, 120, size=40).tolist()
    got, dec = _check(target, target, prompt, 6, k=4, max_seq=64,
                      prefill_buckets=(16,), rounds_per_call=3)
    assert dec.buckets == (16, 64)
    assert got == _target_greedy(target, prompt, 6)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        dec.generate(prompt, 20)
    with pytest.raises(ValueError, match="shared vocabulary"):
        SpeculativeDecoder(target[2], target[3], target[2],
                           tcfg.OPTConfig(**{**target[3].__dict__,
                                             "vocab_size": 64}))
