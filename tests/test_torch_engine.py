"""gill_tpu_torch's DecodeEngine against gill_tpu's on the same carried-over
parameters and the same request traces (tests/test_engine.py's cases).

The engines decode greedily in fp32 on the CPU; tokens must be EXACTLY
equal for every scheduler (run, run_pipelined, run_waves), with EOS, the
budget freeze, read-window buckets, prefix register / extend / drop and
the int8 KV cache; the scheduling statistics must agree too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gill_tpu.config import OPTConfig
from gill_tpu.models import opt as jopt
from gill_tpu.serve.engine import DecodeEngine as JEngine
from gill_tpu.serve.engine import ServeRequest as JRequest
from gill_tpu_torch import config as tcfg
from gill_tpu_torch.models import opt as topt
from gill_tpu_torch.serve.engine import DecodeEngine, ServeRequest
from gill_tpu_torch.weights.from_jax import opt_from_jax

CFG = OPTConfig(num_layers=2, hidden_size=64, ffn_dim=128, num_heads=4,
                vocab_size=128, max_positions=256, word_embed_proj_dim=64)
TCFG = tcfg.OPTConfig(**CFG.__dict__)


@pytest.fixture(scope="module")
def tiny():
    params = jax.device_get(jopt.init(jax.random.PRNGKey(11), CFG))
    return params, opt_from_jax(params)


def _trace(seed, n, plen=(3, 20), new=(2, 12)):
    rng = np.random.RandomState(seed)
    return [(uid, rng.randint(2, 120, size=int(rng.randint(*plen))).tolist(),
             int(rng.randint(*new))) for uid in range(n)]


def _jreqs(trace, pid=None):
    return [JRequest(uid=u, prompt=p, max_new_tokens=n, prefix_id=pid)
            for u, p, n in trace]


def _treqs(trace, pid=None):
    return [ServeRequest(uid=u, prompt=p, max_new_tokens=n, prefix_id=pid)
            for u, p, n in trace]


def _pair(tiny, **kw):
    jp, tp = tiny
    jkw = dict(kw)
    jkw["kv_dtype"] = {torch.float32: jnp.float32,
                       torch.int8: jnp.int8}[kw.get("kv_dtype", torch.float32)]
    kw.setdefault("kv_dtype", torch.float32)
    return (JEngine(jp, CFG, unroll_layers=False, **jkw),
            DecodeEngine(tp, TCFG, **kw))


def test_run_matches_gill_tpu(tiny):
    """test_engine.py:50 — mixed prompt and budget lengths over 3 slots."""
    trace = _trace(0, 7)
    je, te = _pair(tiny, slots=3, max_seq=64, chunk=4,
                   prefill_buckets=(8, 16, 32))
    want = je.run(_jreqs(trace))
    got = te.run(_treqs(trace))
    assert got == want
    assert all(len(got[u]) == n for u, _, n in trace)
    assert te.stats == je.stats


def test_schedulers_match_gill_tpu(tiny):
    """test_engine.py:72 and :170 — run, run_pipelined at several depths
    and run_waves give gill_tpu's tokens."""
    trace = _trace(7, 11, new=(1, 14))
    je, te = _pair(tiny, slots=3, max_seq=64, chunk=4,
                   prefill_buckets=(8, 32))
    want = je.run(_jreqs(trace))
    for depth in (1, 2, 5):
        assert te.run_pipelined(_treqs(trace), depth=depth) == want, depth
    assert te.run_waves(_treqs(trace)) == want
    assert te.run(_treqs(trace)) == want


def test_eos_matches_gill_tpu(tiny):
    """test_engine.py:112 and :190 — a token the model emits mid-stream as
    EOS stops the request in both schedulers, as in gill_tpu."""
    prompt = np.random.RandomState(3).randint(2, 120, size=6).tolist()
    jp, tp = tiny
    kw = dict(slots=2, max_seq=64, chunk=4, prefill_buckets=(8,))
    free = JEngine(jp, CFG, unroll_layers=False, kv_dtype=jnp.float32,
                   **kw).run([JRequest(uid=0, prompt=prompt,
                                       max_new_tokens=10)])[0]
    eos = free[4]
    je, te = _pair(tiny, eos_id=eos, **kw)
    want = je.run([JRequest(uid=0, prompt=prompt, max_new_tokens=10)])[0]
    assert want == free[:free.index(eos) + 1]
    req = [ServeRequest(uid=0, prompt=prompt, max_new_tokens=10)]
    assert te.run(list(req))[0] == want
    assert te.run_pipelined(list(req))[0] == want


def test_prefix_register_extend_drop_match_gill_tpu(tiny):
    """test_engine.py:232 and :318 — cached-prefix requests give
    gill_tpu's tokens (which equal a full prefill's); an extended prefix
    equals registering the concatenation; dropped prefixes are refused."""
    rng = np.random.RandomState(9)
    prefix = rng.randint(2, 120, size=11).tolist()
    sfx = [rng.randint(2, 120, size=int(rng.randint(1, 9))).tolist()
           for _ in range(6)]
    trace = [(i, prefix + s, 6) for i, s in enumerate(sfx)]
    je, te = _pair(tiny, slots=3, max_seq=64, chunk=4,
                   prefill_buckets=(8, 32))
    jpid, tpid = je.register_prefix(prefix), te.register_prefix(prefix)
    want = je.run(_jreqs(trace, jpid))
    assert te.run(_treqs(trace, tpid)) == want
    assert te.run_pipelined(_treqs(trace, tpid)) == want
    assert te.stats["prefix_hits"] == 2 * len(sfx)
    assert te.stats["prefix_tokens_saved"] == 2 * len(prefix) * len(sfx)

    base, turn, tail = prefix[:7], prefix[7:], sfx[0][:3]
    j0 = je.register_prefix(base)
    j1 = je.extend_prefix(j0, turn)
    want = je.run(_jreqs([(0, base + turn + tail, 6)], j1))
    t0 = te.register_prefix(base)
    t1 = te.extend_prefix(t0, turn)
    assert te.run(_treqs([(0, base + turn + tail, 6)], t1)) == want
    assert te.run(_treqs([(0, base + turn + tail, 6)], tpid)) == want
    te.drop_prefix(t0)
    with pytest.raises(ValueError, match="unknown prefix_id"):
        te.run(_treqs([(2, base + [9], 2)], t0))
    with pytest.raises(ValueError, match="unknown prefix_id"):
        te.extend_prefix(t0, [5])
    with pytest.raises(ValueError, match="extension length"):
        te.extend_prefix(t1, [])
    with pytest.raises(ValueError, match="extend prefix"):
        te.run(_treqs([(0, [9, 9, 9, 9], 2)], t1))


def test_kv_read_buckets_match_gill_tpu(tiny):
    """test_engine.py:356 — read-window buckets leave the tokens alone and
    dispatch the same narrow windows as gill_tpu (kv_rows_read)."""
    trace = _trace(23, 11, new=(2, 14))
    kw = dict(slots=4, max_seq=64, chunk=4, prefill_buckets=(8, 16, 32))
    je, te = _pair(tiny, kv_read_buckets=(16, 32, 48), **kw)
    full = DecodeEngine(tiny[1], TCFG, kv_read_buckets=None,
                        kv_dtype=torch.float32, **kw)
    assert te.kv_buckets == (16, 32, 48, 64) and full.kv_buckets == (64,)
    want = je.run_pipelined(_jreqs(trace))
    assert te.run_pipelined(_treqs(trace)) == want
    assert full.run_pipelined(_treqs(trace)) == want
    assert te.stats["kv_rows_read"] == je.stats["kv_rows_read"]
    assert te.stats["kv_rows_read"] < te.stats["chunks"] * te.max_seq
    assert full.stats["kv_rows_read"] == full.stats["chunks"] * full.max_seq


def test_budget_freeze_matches_gill_tpu(tiny):
    """test_engine.py:405 — a deep request next to shallow ones: once its
    budget is spent the window shrinks back, as in gill_tpu."""
    deep = (0, list(range(2, 40)), 20)
    shallow = [(1 + i, [5, 6, 7], 4) for i in range(8)]
    je, te = _pair(tiny, slots=2, max_seq=64, chunk=4, prefill_buckets=(8, 64),
                   kv_read_buckets=(16, 32, 48))
    want = je.run(_jreqs([deep] + shallow))
    got = te.run(_treqs([deep] + shallow))
    assert got == want
    assert te.stats == je.stats
    assert te.stats["kv_rows_read"] < te.stats["chunks"] * 64


def test_int8_kv_matches_gill_tpu(tiny):
    """test_engine.py:425 — the int8 cache (per-token-per-head scales in
    "ks"/"vs") with read-window buckets gives gill_tpu's tokens; prefix
    caching is refused on it."""
    trace = _trace(29, 9, new=(2, 14))
    je, te = _pair(tiny, slots=3, max_seq=64, chunk=4,
                   prefill_buckets=(8, 16, 32), kv_dtype=torch.int8,
                   kv_read_buckets=(16, 32, 48))
    assert set(te.cache) == {"k", "v", "ks", "vs"}
    assert te.cache["k"].dtype == torch.int8
    assert te.cache["ks"].dtype == torch.float32
    want = je.run_pipelined(_jreqs(trace))
    assert te.run_pipelined(_treqs(trace)) == want
    assert te.run(_treqs(trace)) == want
    with pytest.raises(ValueError, match="bf16 KV"):
        te.register_prefix([5, 6, 7])


def test_warmup_is_inert(tiny):
    """test_engine.py:147 — warmup runs dropped prefills and chunks and does
    not change what the engine serves; a wave refills in one prefill."""
    trace = _trace(5, 6, new=(4, 5))
    _, tp = tiny
    plain = DecodeEngine(tp, TCFG, slots=3, max_seq=64, chunk=4,
                         prefill_buckets=(8, 32), kv_dtype=torch.float32)
    want = plain.run(_treqs(trace))
    warm = DecodeEngine(tp, TCFG, slots=3, max_seq=64, chunk=4,
                        prefill_buckets=(8, 32), kv_dtype=torch.float32)
    warm.warmup()
    assert warm.run(_treqs(trace)) == want
    assert warm.stats["prefill_reqs"] == len(trace)
    assert warm.stats["prefills"] < len(trace)


def test_out_of_window_rows_write_nothing():
    """A (B,) cache_pos past a read window's end writes no row (gill_tpu's
    mode="drop" scatter): the pool outside the window is untouched."""
    cfg = tcfg.OPTConfig(num_layers=1, hidden_size=16, ffn_dim=32,
                         num_heads=2, vocab_size=40, max_positions=64,
                         word_embed_proj_dim=16)
    gen = torch.Generator().manual_seed(0)
    from gill_tpu_torch.nn.core import Init

    params = topt.init(Init(gen, "cpu"), cfg)
    pool = topt.init_cache(cfg, 2, 32, device="cpu", dtype=torch.float32)
    before = {k: v.clone() for k, v in pool.items()}
    win = {k: v[:, :, :16] for k, v in pool.items()}
    pos = torch.tensor([5, 20], dtype=torch.int32)
    topt.forward(params, cfg, topt.embed_tokens(params, torch.tensor([[3], [4]])),
                 cache=win, cache_pos=pos)
    for key in ("k", "v"):
        assert bool((pool[key][:, 0, 5] != 0).any())         # written
        changed = (pool[key] != before[key]).flatten(3).any(-1)  # (L, B, S)
        assert changed.nonzero().tolist() == [[0, 0, 5]]
