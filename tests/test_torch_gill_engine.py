"""gill_tpu_torch's GillDecodeEngine against gill_tpu's on a tiny GILLCore
with carried-over parameters (tests/test_gill_engine.py's cases), and the
engines' per-row sampling.

Greedy tokens and valid masks must be exactly equal; the [IMG]-run hidden
taps agree to 2e-4 absolute (test_gill_engine.py's bound: fp32 through
the LM, sums in another order). Sampling cannot match gill_tpu's threefry
bits: its top-p filter is held equal to gill_tpu's on logits, its draws are
held to the inverse CDF at injected uniforms and to the distribution, and
the engine's streams to packing independence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gill_tpu.ops import sampling as jsampling
from gill_tpu.serve.gill_engine import GillDecodeEngine as JEngine
from gill_tpu.serve.gill_engine import GillServeRequest as JRequest
from gill_tpu_torch import config as tcfg
from gill_tpu_torch.models.gill import GILLCore
from gill_tpu_torch.ops import sampling as tsampling
from gill_tpu_torch.serve.gill_engine import GillDecodeEngine, GillServeRequest
from gill_tpu_torch.weights.from_jax import gill_params_from_jax

from test_gill_forward import IMG_START, NUM_TOKENS, make_core


@pytest.fixture(scope="module")
def cores():
    core = make_core()
    params = jax.device_get(core.init_params(jax.random.PRNGKey(3)))
    tcore = GILLCore(
        cfg=tcfg.GILLConfig(**core.cfg.__dict__),
        opt_cfg=tcfg.OPTConfig(**core.opt_cfg.__dict__),
        vis_cfg=tcfg.CLIPVisionConfig(**core.vis_cfg.__dict__),
        vocab_len=core.vocab_len, img_start=core.img_start,
        pad_token_id=core.pad_token_id, bos_token_id=core.bos_token_id)
    return core, params, tcore, gill_params_from_jax(params)


def _embs(rng, p, dim):
    return (rng.randn(p, dim) * 0.02).astype(np.float32)


def _first_run(tokens):
    for i in range(len(tokens) - NUM_TOKENS + 1):
        if tokens[i:i + NUM_TOKENS] == list(range(IMG_START,
                                                  IMG_START + NUM_TOKENS)):
            return i
    return None


def _engines(cores, **kw):
    core, params, tcore, tparams = cores
    return (JEngine(core, params, unroll_layers=False, kv_dtype=jnp.float32,
                    **kw),
            GillDecodeEngine(tcore, tparams, kv_dtype=torch.float32, **kw))


def _both(cores, cases, pid=(None, None), **kw):
    """Runs the same requests through gill_tpu's and the port's engine."""
    je, te = _engines(cores, **kw)
    return _serve(je, te, cases, pid)


def _serve(je, te, cases, pid=(None, None)):
    fields = [dict(uid=c[0], embs=c[1], num_words=c[2],
                   min_word_tokens=c[3], img_scale=c[4]) for c in cases]
    want = je.run([JRequest(prefix_id=pid[0], **f) for f in fields])
    got = te.run([GillServeRequest(prefix_id=pid[1], **f) for f in fields])
    return want, got


def _assert_same(want, got):
    assert set(got) == set(want)
    for u in want:
        assert got[u]["tokens"] == want[u]["tokens"], f"uid {u}"
        np.testing.assert_allclose(got[u]["img_runs"], want[u]["img_runs"],
                                   atol=2e-4, err_msg=f"uid {u}")
        np.testing.assert_array_equal(got[u]["img_hidden"],
                                      got[u]["img_runs"][0])


def test_matches_gill_tpu_engine(cores):
    """test_gill_engine.py:45 — plain text, [IMG]-boosted and min-word-gated
    requests over 3 slots."""
    rng = np.random.RandomState(0)
    cases = []
    for uid in range(7):
        cases.append((uid, _embs(rng, int(rng.randint(3, 14)), 16),
                      int(rng.randint(2, 9)),
                      int(rng.randint(0, 3)) if uid % 2 else 0,
                      100.0 if uid % 3 == 0 else 1.0))
    want, got = _both(cores, cases, slots=3, max_seq=64, chunk=3,
                      prefill_buckets=(8, 16))
    _assert_same(want, got)
    assert any(_first_run(g["tokens"]) is not None for g in got.values())


def test_min_word_gate_and_tap_at_chunk_boundary(cores):
    """test_gill_engine.py:80 and :183 — a huge boost cannot start a run
    before min_word_tokens; a run ending on the final output (budget =
    1 * chunk + 1) still delivers its last tap row."""
    rng = np.random.RandomState(1)
    want, got = _both(cores, [(0, _embs(rng, 5, 16), 6, 3, 1e6)], slots=2,
                      max_seq=64, chunk=4, prefill_buckets=(8,))
    _assert_same(want, got)
    i = _first_run(got[0]["tokens"])
    assert i is not None and i >= 3
    rng = np.random.RandomState(11)
    want, got = _both(cores, [(0, _embs(rng, 5, 16), 2, 1, 1e8)], slots=2,
                      max_seq=64, chunk=4, prefill_buckets=(8,))
    _assert_same(want, got)
    toks = got[0]["tokens"]
    assert _first_run(toks) + NUM_TOKENS == len(toks)
    assert np.abs(got[0]["img_hidden"][-1]).sum() > 0     # not a zero row


def test_multi_run_tap_ring(cores):
    """test_gill_engine.py:210 — each [IMG] run's hiddens in its ring row;
    a request asking more runs than the ring holds is refused."""
    rng = np.random.RandomState(21)
    kw = dict(slots=2, max_seq=64, chunk=5, prefill_buckets=(8,),
              max_img_runs=3)
    je, te = _engines(cores, **kw)
    embs = _embs(rng, 6, 16)
    want = je.run([JRequest(uid=0, embs=embs, num_words=4, img_scale=1e8,
                            max_img_runs=3)])
    got = te.run([GillServeRequest(uid=0, embs=embs, num_words=4,
                                   img_scale=1e8, max_img_runs=3)])
    _assert_same(want, got)
    assert got[0]["img_runs"].shape == (3, NUM_TOKENS, 16)
    assert not np.allclose(got[0]["img_runs"][0], got[0]["img_runs"][1])
    with pytest.raises(ValueError):
        te.run([GillServeRequest(uid=1, embs=embs, num_words=2,
                                 max_img_runs=4)])


def test_prefix_caching_matches_gill_tpu(cores):
    """test_gill_engine.py:274 and :342 — an embedding prefix registered
    (or registered and extended) once, requests carrying only suffix rows."""
    rng = np.random.RandomState(21)
    prefix = _embs(rng, 11, 16)
    cases = [(uid, _embs(rng, int(rng.randint(1, 9)), 16),
              int(rng.randint(2, 8)), 0, 100.0 if uid % 2 == 0 else 1.0)
             for uid in range(6)]
    je, te = _engines(cores, slots=3, max_seq=64, chunk=3,
                      prefill_buckets=(8, 32))
    pid = (je.register_prefix(prefix), te.register_prefix(prefix))
    want, got = _serve(je, te, cases, pid)
    _assert_same(want, got)
    assert te.stats["prefix_hits"] == len(cases)
    assert te.stats["prefix_tokens_saved"] == 11 * len(cases)
    # extend: [prefix[:7]] + prefix[7:] serves what the full prefix serves
    p0 = te.register_prefix(prefix[:7])
    p1 = te.extend_prefix(p0, prefix[7:])
    ext = te.run([GillServeRequest(uid=c[0], embs=c[1], num_words=c[2],
                                   img_scale=c[4], prefix_id=p1)
                  for c in cases])
    _assert_same(want, ext)
    te.drop_prefix(p0)
    with pytest.raises(ValueError, match="unknown prefix_id"):
        te.extend_prefix(p0, prefix[:2])
    with pytest.raises(ValueError, match="extension embs must be"):
        te.extend_prefix(p1, np.zeros((3,), np.float32))
    with pytest.raises(ValueError, match="suffix embedding row"):
        te.run([GillServeRequest(uid=0, embs=prefix[:0], num_words=2,
                                 prefix_id=p1)])


def test_kv_read_buckets_match_gill_tpu(cores):
    """test_gill_engine.py:374 — read-window buckets leave tokens and taps
    alone and dispatch gill_tpu's windows."""
    rng = np.random.RandomState(29)
    cases = [(uid, _embs(rng, int(rng.randint(3, 14)), 16),
              int(rng.randint(2, 9)), 0, 100.0 if uid % 2 == 0 else 1.0)
             for uid in range(6)]
    kw = dict(slots=3, max_seq=64, chunk=3, prefill_buckets=(8, 16),
              kv_read_buckets=(16, 32, 48))
    je, te = _engines(cores, **kw)
    want, got = _serve(je, te, cases)
    _assert_same(want, got)
    assert te.kv_buckets == (16, 32, 48, 64)
    assert te.stats["kv_rows_read"] == je.stats["kv_rows_read"]
    assert te.stats["kv_rows_read"] < te.stats["chunks"] * te.max_seq


def test_admission_checks(cores):
    _, _, tcore, tparams = cores
    te = GillDecodeEngine(tcore, tparams, slots=2, max_seq=32, chunk=4,
                          prefill_buckets=(8, 16, 32), kv_dtype=torch.float32)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        te.run([GillServeRequest(uid=0, embs=np.zeros((20, 16), np.float32),
                                 num_words=20)])
    with pytest.raises(ValueError, match="sampling=True"):
        te.run([GillServeRequest(uid=0, embs=np.zeros((4, 16), np.float32),
                                 num_words=2, temperature=1.0)])
    with pytest.raises(ValueError, match="int8"):
        GillDecodeEngine(tcore, tparams, kv_dtype=torch.int8)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_per_row_top_p_filter_matches_gill_tpu():
    rng = np.random.RandomState(6)
    logits = (rng.randn(4, 50) * 2).astype(np.float32)
    top_p = np.array([0.3, 0.9, 1.0, 0.5], np.float32)
    want = np.asarray(jsampling.top_p_filter(jnp.asarray(logits),
                                             jnp.asarray(top_p)[:, None]))
    got = tsampling.top_p_filter(torch.from_numpy(logits),
                                 torch.from_numpy(top_p)[:, None]).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[~np.isinf(got)], want[~np.isinf(want)])


def test_sample_per_row_is_the_inverse_cdf_at_injected_uniforms():
    rng = np.random.RandomState(7)
    logits = (rng.randn(5, 40) * 2).astype(np.float32)
    temp = np.array([0.7, 1.0, 0.0, 2.0, 1.3], np.float32)
    top_p = np.array([0.9, 1.0, 1.0, 0.5, 0.8], np.float32)
    u = np.array([0.1, 0.5, 0.3, 0.99, 0.0], np.float32)
    got = tsampling.sample_per_row(torch.from_numpy(logits),
                                   torch.from_numpy(temp),
                                   torch.from_numpy(top_p),
                                   torch.from_numpy(u)).numpy()
    filt = np.asarray(jsampling.top_p_filter(
        jnp.asarray(logits / np.maximum(temp, 1e-6)[:, None]),
        jnp.asarray(top_p)[:, None]), np.float64)
    for r in range(5):
        if temp[r] == 0:
            assert got[r] == int(np.argmax(logits[r]))
            continue
        p = np.exp(filt[r] - filt[r].max())
        cdf = np.cumsum(p / p.sum())
        want = int(np.searchsorted(cdf, (1 - u[r]) * cdf[-1] - 1e-6))
        assert got[r] == want, r
        assert np.isfinite(filt[r, got[r]])            # never a filtered id


def test_sample_per_row_follows_the_distribution():
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0]]).repeat(4000, 1)
    temp = torch.full((4000,), 1.0)
    u = torch.rand(4000, generator=torch.Generator().manual_seed(0))
    tok = tsampling.sample_per_row(logits, temp, torch.ones(4000), u)
    freq = np.bincount(tok.numpy(), minlength=4) / 4000
    np.testing.assert_allclose(freq, torch.softmax(logits[0], -1).numpy(),
                               atol=0.03)


def test_engine_sampling_streams(cores):
    """test_gill_engine.py:121 — greedy rows unchanged in a sampling engine,
    sampled streams independent of slot packing and chunking, different
    seeds give different streams, forced [IMG] still commits."""
    core, params, tcore, tparams = cores
    rng = np.random.RandomState(9)
    embs = [_embs(rng, int(rng.randint(4, 10)), 16) for _ in range(5)]
    reqs = [GillServeRequest(uid=0, embs=embs[0], num_words=6),
            GillServeRequest(uid=1, embs=embs[1], num_words=6,
                             temperature=1.0, top_p=0.9, seed=11),
            GillServeRequest(uid=2, embs=embs[2], num_words=6,
                             temperature=1.0, top_p=0.9, seed=12),
            GillServeRequest(uid=3, embs=embs[3], num_words=6,
                             temperature=5.0, seed=13),
            GillServeRequest(uid=4, embs=embs[4], num_words=5,
                             temperature=0.7, top_p=0.95, seed=14,
                             img_scale=1e8)]

    def mk(slots, chunk):
        return GillDecodeEngine(tcore, tparams, slots=slots, max_seq=64,
                                chunk=chunk, prefill_buckets=(8, 16),
                                kv_dtype=torch.float32, sampling=True)
    out2, out3 = mk(2, 3).run(reqs), mk(3, 4).run(reqs)
    for r in reqs:
        assert out2[r.uid]["tokens"] == out3[r.uid]["tokens"], r.uid
    want = JEngine(core, params, slots=2, max_seq=64, chunk=3,
                   prefill_buckets=(8, 16), unroll_layers=False,
                   kv_dtype=jnp.float32).run(
        [JRequest(uid=0, embs=embs[0], num_words=6)])
    assert out2[0]["tokens"] == want[0]["tokens"]
    o = mk(2, 3).run([GillServeRequest(uid=0, embs=embs[1], num_words=8,
                                       temperature=5.0, seed=1),
                      GillServeRequest(uid=1, embs=embs[1], num_words=8,
                                       temperature=5.0, seed=2)])
    assert o[0]["tokens"] != o[1]["tokens"]
    assert _first_run(out2[4]["tokens"]) is not None
