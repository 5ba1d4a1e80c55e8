"""gill_tpu_torch's online serving (serve/online.py OnlineEngine and the
serve/http.py front end) against gill_tpu's DecodeEngine.run on the same
carried-over parameters: tests/test_serve_online.py's nine cases.

The engines decode greedily in fp32 on the CPU; every token list must be
EXACTLY gill_tpu's. The cancel cases order their events with an
Event-gated `_run_chunk` (the scheduler parks inside a chosen chunk until
the test has acted), never with sleeps, so each cancel lands at a known
chunk boundary and the partial token counts are exact.
"""

import json
import socket
import struct
import threading
import urllib.error
import urllib.request

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
from gill_tpu_torch.serve import engine as engine_mod
from gill_tpu_torch.serve import online as online_mod
from gill_tpu_torch.serve.engine import DecodeEngine
from gill_tpu_torch.serve.http import make_server
from gill_tpu_torch.serve.online import OnlineEngine
from gill_tpu_torch.weights.from_jax import opt_from_jax

CFG = OPTConfig(num_layers=2, hidden_size=64, ffn_dim=128, num_heads=4,
                vocab_size=128, max_positions=256, word_embed_proj_dim=64)
TCFG = tcfg.OPTConfig(**CFG.__dict__)
KW = dict(max_seq=64, chunk=4, prefill_buckets=(8, 32))
WAIT = 120          # seconds any wait of a test may take before it fails


@pytest.fixture(scope="module")
def tiny():
    params = jax.device_get(jopt.init(jax.random.PRNGKey(11), CFG))
    return params, opt_from_jax(params)


@pytest.fixture(scope="module")
def want(tiny):
    """gill_tpu's batch tokens: want(requests, slots) -> {uid: tokens}, one
    JAX engine a slot count (each compiles once)."""
    engines = {}

    def run(reqs, slots=3):
        if slots not in engines:
            engines[slots] = JEngine(tiny[0], CFG, slots=slots,
                                     unroll_layers=False,
                                     kv_dtype=jnp.float32, **KW)
        return engines[slots].run([JRequest(uid=i, prompt=p,
                                            max_new_tokens=m)
                                   for i, (p, m) in enumerate(reqs)])
    return run


def _engine(tiny, slots=3):
    return DecodeEngine(tiny[1], TCFG, slots=slots, kv_dtype=torch.float32,
                        **KW)


def _mk_reqs(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randint(2, 120, size=int(rng.randint(3, 20))).tolist(),
             int(rng.randint(2, 12))) for _ in range(n)]


def _gate(monkeypatch, eng, holds: dict):
    """Parks the scheduler inside `_run_chunk` call n (1-based) until
    holds[n][1] is set; holds[n][0] is set once it is parked there."""
    orig = eng._run_chunk
    calls = [0]

    def gated():
        calls[0] += 1
        if calls[0] in holds:
            parked, go = holds[calls[0]]
            parked.set()
            assert go.wait(WAIT), "test did not release the chunk"
        return orig()

    monkeypatch.setattr(eng, "_run_chunk", gated)


def _serve(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _post(url, body):
    rq = urllib.request.Request(url, data=json.dumps(body).encode(),
                                headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(rq, timeout=WAIT) as r:
        return json.loads(r.read())


def test_online_matches_batch(tiny, want):
    reqs = _mk_reqs(8, 0)
    batch = want(reqs)
    online = OnlineEngine(_engine(tiny))
    try:
        handles = [online.submit(p, m) for p, m in reqs]
        for i, h in enumerate(handles):
            assert h.result(timeout=WAIT) == batch[i], f"req {i}"
        assert online.eng.stats["tokens_out"] == sum(m for _, m in reqs)
    finally:
        online.close()
    assert not online._thread.is_alive()


def test_online_streaming_is_incremental(tiny, want):
    """stream() yields the same tokens, and requests submitted while one
    is decoding join the running batch."""
    reqs = _mk_reqs(4, 1)
    batch = want(reqs)
    online = OnlineEngine(_engine(tiny))
    try:
        h0 = online.submit(*reqs[0])
        it = h0.stream()
        streamed = [next(it)]            # the first chunk has landed ...
        rest = [online.submit(p, m) for p, m in reqs[1:]]   # ... join it
        streamed.extend(it)
        assert streamed == batch[0]
        for i, h in enumerate(rest, start=1):
            assert h.result(timeout=WAIT) == batch[i], f"req {i}"
    finally:
        online.close()


def test_online_submit_validates(tiny):
    online = OnlineEngine(_engine(tiny))
    try:
        with pytest.raises(ValueError, match="exceeds max_seq"):
            online.submit([5] * 60, 30)      # 60 + 30 > max_seq 64
        with pytest.raises(ValueError, match="unknown prefix_id"):
            online.submit([5, 6], 2, prefix_id=3)
        with pytest.raises(ValueError, match="prefix length"):
            online.register_prefix([])
    finally:
        online.close()
    with pytest.raises(RuntimeError, match="closed"):
        online.submit([5, 6], 2)


def test_http_server_end_to_end(tiny, want):
    reqs = _mk_reqs(3, 2)
    batch = want(reqs)
    online = OnlineEngine(_engine(tiny))
    srv = make_server(online, port=0)
    base = _serve(srv)
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=WAIT) as r:
            assert json.loads(r.read()) == {"ok": True}

        # concurrent non-stream posts share the slot pool
        results = [None] * len(reqs)

        def post(i):
            p, m = reqs[i]
            results[i] = _post(f"{base}/v1/generate",
                               {"prompt": p, "max_new_tokens": m})["tokens"]

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT)
            assert not th.is_alive()
        assert results == [batch[i] for i in range(len(reqs))]

        # streaming: NDJSON lines, one a token, then done
        p, m = reqs[0]
        body = json.dumps({"prompt": p, "max_new_tokens": m,
                           "stream": True}).encode()
        rq = urllib.request.Request(f"{base}/v1/generate", data=body,
                                    headers={"Content-Type":
                                             "application/json"})
        with urllib.request.urlopen(rq, timeout=WAIT) as r:
            lines = [json.loads(ln) for ln in r.read().splitlines() if ln]
        assert lines[-1]["done"] is True and lines[-1]["n"] == m
        assert [ln["token"] for ln in lines[:-1]] == batch[0]

        # "text" without a tokenizer, and an unknown route
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/generate", {"text": "hi"})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/nothing", {})
        assert e.value.code == 404

        with urllib.request.urlopen(f"{base}/stats", timeout=WAIT) as r:
            stats = json.loads(r.read())
        assert stats["lm"]["tokens_out"] == 2 * m + sum(
            mm for _, mm in reqs[1:])
    finally:
        srv.shutdown()
        srv.server_close()
        online.close()


def test_cancel_queued_in_flight_and_done(tiny, want, monkeypatch):
    """cancel(): a queued request completes at once with no tokens; one in
    flight completes with the prefix streamed up to the chunk boundary
    where the cancel lands, and frees its slot for waiting work; a
    finished one is unaffected. The scheduler parks inside chunk 2 while
    the test cancels, so the cancel lands at the boundary after chunk 2:
    the request in flight has its prefill token and two chunks' tokens."""
    full = want([([7, 9, 11], 40)], slots=1)[0]
    want_c = want([([8, 4], 5)], slots=1)[0]
    eng = _engine(tiny, slots=1)
    parked, go = threading.Event(), threading.Event()
    _gate(monkeypatch, eng, {2: (parked, go)})
    online = OnlineEngine(eng)
    try:
        a = online.submit([7, 9, 11], 40)
        it = a.stream()
        first = next(it)                  # chunk 1 landed: a is in flight
        assert parked.wait(WAIT)          # the scheduler is inside chunk 2
        b = online.submit([5, 6], 30)     # queued behind a (one slot)
        c = online.submit([8, 4], 5)      # queued
        b.cancel()
        a.cancel()
        go.set()
        assert b.result(timeout=WAIT) == [] and b.cancelled
        got = a.result(timeout=WAIT)
        assert [first] + list(it) == got  # the stream simply ends
        assert got == full[:1 + 2 * eng.chunk]
        # the freed slot serves the waiting request to completion
        assert c.result(timeout=WAIT) == want_c
        c.cancel()                        # cancel after completion: no-op
        assert c.result(timeout=WAIT) == want_c
        assert online.eng.stats["cancelled"] == 2
    finally:
        go.set()
        online.close()


def test_http_stream_client_disconnect_cancels(tiny, want, monkeypatch):
    """A client that resets its connection mid-stream cancels its request:
    the slot frees at the next chunk boundary and serves waiting work
    instead of decoding to completion for nobody. Chunk 1 waits until the
    client has reset, so the server's first token write fails; chunk 2
    waits until the handler has cancelled."""
    want_d = want([([5, 6], 4)], slots=1)[0]
    eng = _engine(tiny, slots=1)
    reset, cancelled = threading.Event(), threading.Event()
    _gate(monkeypatch, eng, {1: (threading.Event(), reset),
                             2: (threading.Event(), cancelled)})
    orig_cancel = online_mod.RequestHandle.cancel

    def cancel(self):
        orig_cancel(self)
        cancelled.set()

    monkeypatch.setattr(online_mod.RequestHandle, "cancel", cancel)
    online = OnlineEngine(eng)
    srv = make_server(online, port=0)
    _serve(srv)
    try:
        body = json.dumps({"prompt": [7, 9, 11], "max_new_tokens": 50,
                           "stream": True}).encode()
        raw = (b"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
               b"Content-Type: application/json\r\n"
               + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        s = socket.create_connection(("127.0.0.1", srv.server_address[1]),
                                     timeout=WAIT)
        s.sendall(raw)
        assert s.recv(1)                  # the stream's headers landed
        # abort with RST, so the server's next chunk write fails
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))
        s.close()
        reset.set()
        # one slot: this runs only once the cancelled request freed it
        assert online.submit([5, 6], 4).result(timeout=WAIT) == want_d
        assert online.eng.stats["cancelled"] == 1
    finally:
        reset.set()
        cancelled.set()
        srv.shutdown()
        srv.server_close()
        online.close()


def test_online_prefix_caching_matches(tiny, want):
    """register_prefix rides the scheduler thread; prefixed submissions
    give the full prefill's tokens and count prefix hits; bad references
    fail the caller, and a dropped prefix fails its queued requests."""
    rng = np.random.RandomState(5)
    prefix = rng.randint(2, 120, size=9).tolist()
    suffixes = [rng.randint(2, 120, size=int(rng.randint(1, 8))).tolist()
                for _ in range(4)]
    batch = want([(prefix + sfx, 5) for sfx in suffixes])
    online = OnlineEngine(_engine(tiny))
    try:
        pid = online.register_prefix(prefix)
        with pytest.raises(ValueError, match="unknown prefix_id"):
            online.submit(prefix + [9], 2, prefix_id=pid + 1)
        with pytest.raises(ValueError, match="extend prefix"):
            online.submit([9] + prefix, 2, prefix_id=pid)
        handles = [online.submit(prefix + sfx, 5, prefix_id=pid)
                   for sfx in suffixes]
        for i, h in enumerate(handles):
            assert h.result(timeout=WAIT) == batch[i], f"req {i}"
        assert online.eng.stats["prefix_hits"] == len(suffixes)
        assert online.eng.stats["prefix_tokens_saved"] == 9 * len(suffixes)
    finally:
        online.close()


def test_http_prefix_route(tiny, want):
    rng = np.random.RandomState(6)
    prefix = rng.randint(2, 120, size=7).tolist()
    sfx = rng.randint(2, 120, size=4).tolist()
    batch = want([(prefix + sfx, 5)])
    online = OnlineEngine(_engine(tiny))
    srv = make_server(online, port=0)
    base = _serve(srv)
    try:
        reg = _post(f"{base}/v1/prefix", {"prompt": prefix})
        assert reg["len"] == len(prefix)
        got = _post(f"{base}/v1/generate",
                    {"prompt": prefix + sfx, "max_new_tokens": 5,
                     "prefix_id": reg["prefix_id"]})
        assert got["tokens"] == batch[0] and got["text"] is None
        # a bad prefix reference -> 400, and the engine stays up
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/generate", {"prompt": [9, 9],
                                          "max_new_tokens": 2,
                                          "prefix_id": 999})
        assert e.value.code == 400
        with urllib.request.urlopen(f"{base}/healthz", timeout=WAIT) as r:
            assert json.loads(r.read()) == {"ok": True}
        assert online._thread.is_alive()
    finally:
        srv.shutdown()
        srv.server_close()
        online.close()


def test_http_prefix_extend_and_drop(tiny, want):
    """/v1/prefix {"extend": pid} grows a prefix by prefilling only the new
    tokens; {"drop": pid} frees it and later references get 400."""
    rng = np.random.RandomState(8)
    base = rng.randint(2, 120, size=6).tolist()
    turn = rng.randint(2, 120, size=4).tolist()
    sfx = rng.randint(2, 120, size=3).tolist()
    batch = want([(base + turn + sfx, 5)])
    online = OnlineEngine(_engine(tiny))
    srv = make_server(online, port=0)
    addr = _serve(srv)
    try:
        pid0 = _post(f"{addr}/v1/prefix", {"prompt": base})["prefix_id"]
        ext = _post(f"{addr}/v1/prefix", {"extend": pid0, "prompt": turn})
        assert ext["len"] == len(turn)
        got = _post(f"{addr}/v1/generate",
                    {"prompt": base + turn + sfx, "max_new_tokens": 5,
                     "prefix_id": ext["prefix_id"]})
        assert got["tokens"] == batch[0]
        assert _post(f"{addr}/v1/prefix", {"drop": pid0}) == {"ok": True}
        for body in ({"extend": pid0, "prompt": turn}, {"drop": pid0}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{addr}/v1/prefix", body)
            assert e.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()
        online.close()


def test_dropped_prefix_fails_queued_requests(tiny, want, monkeypatch):
    """A prefix dropped while a request naming it waits for a slot fails
    that request ("unknown prefix_id"), not the scheduler: the request
    queued behind it still runs."""
    rng = np.random.RandomState(12)
    prefix = rng.randint(2, 120, size=5).tolist()
    long_req = ([7, 9, 11], 12)
    after = ([8, 4], 5)
    eng = _engine(tiny, slots=1)
    parked, go = threading.Event(), threading.Event()
    online = OnlineEngine(eng)
    try:
        pid = online.register_prefix(prefix)
        _gate(monkeypatch, eng, {1: (parked, go)})
        a = online.submit(*long_req)
        assert parked.wait(WAIT)          # a holds the only slot
        b = online.submit(prefix + [9, 9], 3, prefix_id=pid)
        c = online.submit(*after)
        # drop_prefix's ticket, queued behind b and c before chunk 1 ends:
        # the scheduler takes all three at that boundary, the drop first
        drop = online_mod._PrefixReg(None, drop=pid)
        online._q.put(drop)
        go.set()
        assert drop.done.wait(WAIT) and drop.error is None
        with pytest.raises(RuntimeError, match="unknown prefix_id"):
            b.result(timeout=WAIT)
        assert a.result(timeout=WAIT) == want([long_req], slots=1)[0]
        assert c.result(timeout=WAIT) == want([after], slots=1)[0]
        assert online._thread.is_alive()
    finally:
        go.set()
        online.close()


def test_head_rows_is_the_plain_head_product():
    """`head_rows`, a prefill wave's first-token logits computed as one
    `slots`-row product (so the card's GEMM keeps one algorithm whatever
    the wave's size): the plain fp32 product's rows, within fp32
    summation order (1e-5), and the same greedy tokens."""
    g = torch.Generator().manual_seed(0)
    head = torch.randn(128, 64, generator=g)
    for r in (1, 3, 8):
        h = torch.randn(r, 64, generator=g)
        got = engine_mod.head_rows(h, head, 8)
        plain = h @ head.t()
        assert got.shape == (r, 128)
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
        assert torch.equal(got.argmax(-1), plain.argmax(-1))


def test_online_refills_prefill_in_waves(tiny, want, monkeypatch):
    """Requests that queue while a chunk runs join at its boundary and
    prefill together, one forward a wave (gill_tpu's schedule, on every
    device), with gill_tpu's tokens."""
    reqs = _mk_reqs(7, 13)
    batch = want(reqs)
    eng = _engine(tiny)
    parked, go = threading.Event(), threading.Event()
    _gate(monkeypatch, eng, {1: (parked, go)})
    online = OnlineEngine(eng)
    try:
        handles = [online.submit(*reqs[0])]
        assert parked.wait(WAIT)          # request 0 alone, in chunk 1
        handles += [online.submit(p, m) for p, m in reqs[1:]]
        go.set()
        assert [h.result(timeout=WAIT) for h in handles] == \
            [batch[i] for i in range(len(reqs))]
        stats = eng.stats
        assert stats["prefill_reqs"] == len(reqs)
        # request 0 alone, then the two free slots in one wave, ...
        assert stats["prefills"] <= len(reqs) - 1
    finally:
        go.set()
        online.close()
