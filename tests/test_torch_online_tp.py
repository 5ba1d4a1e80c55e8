"""Online serving over tensor-parallel and replicated engines
(serve/online.py's leader / follower protocol) against gill_tpu's engines.

One 2-rank gloo launch on the CPU (`torch_dist_cases.online_tp`) serves
every case, one online engine after another, and the tests below assert
on its results. fp32 throughout, so every greedy token list must be
EXACTLY gill_tpu's DecodeEngine / GillDecodeEngine tokens for the same
requests, and the [IMG] taps within 2e-4 absolute
(tests/test_torch_gill_engine.py's bound):
  * OnlineEngine at mesh (1, 2) under staggered submits, a queued and an
    in-flight cancel (the leader's chunks held by Events, so each cancel
    lands at a known boundary), a prefix registered, extended and
    dropped, and a request after an idle spell longer than the group's
    timeout (the leader's heartbeat ticks keep the followers' waits
    short);
  * GillOnlineEngine at mesh (1, 2) with an embedding prefix;
  * OnlineEngine at mesh (2, 1) (two replicas);
  * a follower whose collect raises: rank 0's handle fails within the
    group's timeout plus a margin, naming the rank, and every scheduler
    ends.
Every follower's engine counters must equal rank 0's (the slot states
moved together) and its public calls must raise, naming rank 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gill_tpu.config import OPTConfig
from gill_tpu.serve.engine import DecodeEngine as JEngine
from gill_tpu.serve.engine import ServeRequest as JRequest
from gill_tpu.serve.gill_engine import GillDecodeEngine as JGEngine
from gill_tpu.serve.gill_engine import GillServeRequest as JGRequest

import torch_dist_cases as cases
from test_torch_dist_tp import (CORE_KW, ENGINE_KW, GILL_ENGINE_KW, OPT,
                                TOL, _jcore)

SEED = 3
PG_TIMEOUT = 8.0                 # the world's timeout once the group is up
IDLE_S = PG_TIMEOUT + 1.0        # longer than the timeout, > 2 heartbeats
FAULT_BOUND_S = PG_TIMEOUT + 10.0


def _reqs(rng, n, new=(2, 9)):
    return [(rng.randint(3, 60, size=int(rng.randint(3, 12))).tolist(),
             int(rng.randint(*new))) for _ in range(n)]


def _jrun(eng, reqs, pids=None):
    out = eng.run([JRequest(uid=u, prompt=p, max_new_tokens=n,
                            prefix_id=None if pids is None else pids[u])
                   for u, (p, n) in enumerate(reqs)])
    return [out[u] for u in range(len(reqs))]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """gill_tpu's tokens for every case, and the one launch."""
    rng = np.random.RandomState(5)
    params = cases.make_params(CORE_KW, SEED)
    staggered = _reqs(rng, 6)
    cancel = {"warm": _reqs(rng, 1, (1, 2))[0],
              "reqs": _reqs(rng, 4, (10, 14)), "in_flight": 1, "queued": 3}
    prefix = {"prefix": rng.randint(3, 60, size=9).tolist(),
              "extension": rng.randint(3, 60, size=4).tolist()}
    full_pfx = prefix["prefix"] + prefix["extension"]
    prefix["reqs"] = [(base + rng.randint(3, 60, size=int(rng.randint(
        1, 6))).tolist(), int(rng.randint(2, 8)), k)
        for base, k in ((full_pfx, 1), (prefix["prefix"], 0),
                        (full_pfx, 1))]
    gill = {"prefix": (rng.randn(7, 32) * 0.02).astype(np.float32),
            "cases": [dict(embs=(rng.randn(int(rng.randint(1, 8)), 32)
                                 * 0.02).astype(np.float32),
                           num_words=int(rng.randint(2, 7)),
                           img_scale=100.0 if u % 2 == 0 else 1.0,
                           prefixed=u != 1) for u in range(4)]}

    je = JEngine(params["lm"], OPTConfig(**OPT), unroll_layers=False,
                 kv_dtype=jnp.float32, **ENGINE_KW)
    want = {"staggered": _jrun(je, staggered),
            "warm": _jrun(je, [cancel["warm"]])[0],
            "cancel": _jrun(je, cancel["reqs"])}
    pid0 = je.register_prefix(prefix["prefix"])
    pid1 = je.extend_prefix(pid0, prefix["extension"])
    want["prefix"] = _jrun(je, [(p, n) for p, n, _ in prefix["reqs"]],
                           [[pid0, pid1][k] for _, _, k in prefix["reqs"]])
    want["pids"] = [pid0, pid1]
    jg = JGEngine(_jcore(), params, unroll_layers=False,
                  kv_dtype=jnp.float32, **GILL_ENGINE_KW)
    gpid = jg.register_prefix(gill["prefix"])
    g = jg.run([JGRequest(uid=u, embs=c["embs"], num_words=c["num_words"],
                          img_scale=c["img_scale"],
                          prefix_id=gpid if c["prefixed"] else None)
                for u, c in enumerate(gill["cases"])])
    want["gill"] = [g[u] for u in range(len(gill["cases"]))]

    res = cases.run("online_tp", 2, tmp_path_factory.mktemp("online_tp"),
                    timeout=240.0, core_kw=CORE_KW, seed=SEED, opt_kw=OPT,
                    engine_kw=ENGINE_KW, gill_engine_kw=GILL_ENGINE_KW,
                    staggered=staggered, cancel=cancel, prefix=prefix,
                    gill=gill, idle_s=IDLE_S, pg_timeout=PG_TIMEOUT)
    return {"want": want, "lead": res[0], "follower": res[1],
            "cancel": cancel}


def test_tp2_staggered_submits_match_gill_tpu(served):
    assert served["lead"]["staggered"] == served["want"]["staggered"]


def test_tp2_cancels_a_queued_and_an_in_flight_request(served):
    lead, want, c = served["lead"], served["want"], served["cancel"]
    got = lead["cancel"]
    assert got["warm"] == want["warm"]
    for i, toks in enumerate(got["reqs"]):
        if i == c["queued"]:
            assert toks == []                 # never admitted
        elif i == c["in_flight"]:
            # admitted at boundary 2, cancelled during chunk 2: its prefill
            # token and the chunk's 3 steps were streamed
            assert toks == want["cancel"][i][:1 + ENGINE_KW["chunk"]]
            assert len(toks) < len(want["cancel"][i])
        else:
            assert toks == want["cancel"][i], i
    assert got["flags"] == [i in (c["queued"], c["in_flight"])
                            for i in range(len(got["reqs"]))]
    assert lead["stats"]["cancelled"] == 2


def test_tp2_prefix_register_extend_drop(served):
    lead, want = served["lead"], served["want"]
    assert lead["prefix"]["pids"] == want["pids"]
    assert lead["prefix"]["tokens"] == want["prefix"]
    assert "unknown prefix_id" in lead["prefix"]["dropped"]
    assert lead["stats"]["prefix_hits"] == len(want["prefix"])


def test_tp2_serves_after_an_idle_spell_past_the_timeout(served):
    lead = served["lead"]
    assert lead["heartbeat_s"] == pytest.approx(PG_TIMEOUT / 4)
    assert IDLE_S > max(PG_TIMEOUT, 2 * lead["heartbeat_s"])
    assert lead["after_idle"] == served["want"]["staggered"][0]


def test_tp2_gill_online_matches_gill_tpu(served):
    got, want = served["lead"]["gill"], served["want"]["gill"]
    for g, w in zip(got, want):
        assert g["tokens"] == w["tokens"]
        np.testing.assert_allclose(g["img_runs"], w["img_runs"], atol=TOL)
    assert any(65 in w["tokens"] for w in want)       # an [IMG] run


def test_mesh_2x1_replicas_match_gill_tpu(served):
    assert served["lead"]["replicas"] == served["want"]["staggered"]


def test_followers_move_with_the_leader(served):
    lead, fol = served["lead"], served["follower"]
    for key, stats in (("follower", "stats"), ("gill_follower",
                                                "gill_stats"),
                       ("replica_follower", "replica_stats")):
        f = fol[key]
        assert "rank 0" in f["refused"] and "wait_closed" in f["refused"]
        for k in ("prefills", "prefill_reqs", "chunks", "decode_steps",
                  "prefix_hits", "kv_rows_read", "cancelled"):
            assert f["stats"].get(k) == lead[stats].get(k), (key, k)


def test_a_follower_fault_fails_the_leaders_handles(served):
    lead, fol = served["lead"]["fault"], served["follower"]["fault"]
    assert lead["error"] is not None and "rank 1" in lead["error"]
    assert "a fault injected on a follower" in lead["error"]
    assert lead["s"] < FAULT_BOUND_S
    assert "rank 1" in lead["crash"]
    assert "a fault injected" in fol["crash"]
    assert not lead["thread_alive"] and not fol["thread_alive"]
