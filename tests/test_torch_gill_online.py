"""gill_tpu_torch's online GILL serving (serve/online.py GillOnlineEngine,
the /v1/gill and /v1/gill_prefix routes of serve/http.py, and the async
API of api.py) against gill_tpu: tests/test_gill_online.py's eight cases,
plus generate_async -> finalize_async and add_bos=False on the tiny
checkpoint of tests/test_torch_gill_e2e.py.

Engine cases carry a tiny GILLCore's parameters into the port and hold the
streamed tokens and valid prefixes EXACTLY to gill_tpu's GillDecodeEngine,
and the [IMG] taps to 2e-4 absolute (tests/test_torch_gill_engine.py's
bound: fp32 through the LM, sums in another order). The API and HTTP
cases hold tokens, captions and the route (text or [IMG], the decision's
label) equal to gill_tpu's GILL on the same checkpoint; the SD images come
from the two packages' own random streams, so only their size is held.
The cancel case orders its events with an Event-gated `_run_chunk`.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gill_tpu.serve.gill_engine import GillDecodeEngine as JEngine
from gill_tpu.serve.gill_engine import GillServeRequest as JRequest
from gill_tpu_torch import config as tcfg
from gill_tpu_torch.models.gill import GILLCore
from gill_tpu_torch.serve.gill_engine import GillDecodeEngine
from gill_tpu_torch.serve.http import make_server
from gill_tpu_torch.serve.online import GillOnlineEngine
from gill_tpu_torch.weights.from_jax import gill_params_from_jax

from test_gill_forward import make_core
from test_torch_gill_e2e import _image, ckpt_dir, models  # noqa: F401
from torch_threads import one_intra_op_thread  # noqa: F401

TAP_ATOL = 2e-4
WAIT = 300          # seconds any wait of a test may take before it fails
ENG = dict(slots=2, max_seq=64, chunk=3, prefill_buckets=(8, 16))


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


@pytest.fixture(scope="module")
def want(cores):
    """gill_tpu's batch results: want([(embs, num_words, img_scale)],
    prefix) -> {uid: {"tokens", "img_hidden", "img_runs"}}; one JAX engine
    (it compiles once), prefixes registered on it by `prefix`."""
    core, params = cores[:2]
    eng = JEngine(core, params, unroll_layers=False, kv_dtype=jnp.float32,
                  **ENG)

    def run(cases, prefix=None):
        pid = None if prefix is None else eng.register_prefix(prefix)
        return eng.run([JRequest(uid=i, embs=e, num_words=nw, img_scale=sc,
                                 prefix_id=pid)
                        for i, (e, nw, sc) in enumerate(cases)])
    return run


@pytest.fixture(scope="module")
def api(models):
    """The tiny checkpoint's two models; their online engines closed at
    the end."""
    yield models
    for m in models:
        for online in getattr(m, "_online_engines", {}).values():
            online.close()


def _online(cores):
    return GillOnlineEngine(GillDecodeEngine(cores[2], cores[3],
                                             kv_dtype=torch.float32, **ENG))


def _embs(rng, p):
    return (rng.randn(p, 16) * 0.02).astype(np.float32)


def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _post(url, body):
    rq = urllib.request.Request(url, data=json.dumps(body).encode(),
                                headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(rq, timeout=WAIT) as r:
        return json.loads(r.read())


def _b64(img):
    buf = io.BytesIO()
    img.save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _same_route(got, want):
    """Captions equal; each [IMG] run's dict has the same decision label
    (and probabilities to 1e-5) and one generated image or embedding."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, str):
            assert g == w
        else:
            assert g["decision"][0] == w["decision"][0]
            np.testing.assert_allclose(g["decision"][1:], w["decision"][1:],
                                       atol=1e-5)
            assert len(g["gen"]) == len(w["gen"]) == 1


def test_gill_online_matches_batch(cores, want):
    rng = np.random.RandomState(2)
    cases = [(_embs(rng, int(rng.randint(3, 12))), int(rng.randint(2, 7)),
              100.0 if uid % 2 == 0 else 1.0) for uid in range(5)]
    batch = want(cases)
    online = _online(cores)
    try:
        handles = [online.submit(e, nw, img_scale=sc) for e, nw, sc in cases]
        for u, h in enumerate(handles):
            assert h.result(timeout=WAIT) == batch[u]["tokens"], f"uid {u}"
            np.testing.assert_allclose(h.img_hidden, batch[u]["img_hidden"],
                                       atol=TAP_ATOL)
            np.testing.assert_array_equal(h.img_hidden, h.img_runs[0])
        assert any(len(h.tokens) > nw for h, (_, nw, _) in
                   zip(handles, cases))          # some [IMG] run committed
    finally:
        online.close()


def test_gill_online_streams_incrementally(cores, want):
    rng = np.random.RandomState(3)
    embs = _embs(rng, 6)
    batch = want([(embs, 8, 1.0)])
    online = _online(cores)
    try:
        h = online.submit(embs, 8)
        it = h.stream()
        first = next(it)                 # the first chunk's valid tokens
        assert len(h.tokens) < 8         # ... before the last chunk's
        assert [first] + list(it) == batch[0]["tokens"]
    finally:
        online.close()


def test_online_scheduler_crash_fails_handles(cores, monkeypatch):
    """A crash of the scheduler FAILS the handles in flight (result() and
    stream() raise) instead of stranding their callers, and later submits
    and prefix tickets are refused."""
    online = _online(cores)

    def boom(*a, **k):
        raise RuntimeError("induced device failure")

    monkeypatch.setattr(online.eng, "_chunk", boom)
    rng = np.random.RandomState(4)
    h = online.submit(_embs(rng, 5), 4)
    with pytest.raises(RuntimeError, match="induced device failure"):
        h.result(timeout=WAIT)
    with pytest.raises(RuntimeError, match="induced device failure"):
        list(h.stream())
    online._thread.join(timeout=WAIT)
    assert not online._thread.is_alive()
    assert "induced device failure" in online.crash
    with pytest.raises(RuntimeError, match="closed"):
        online.submit(_embs(rng, 5), 4)
    with pytest.raises(RuntimeError, match="closed"):
        online.register_prefix(_embs(rng, 3))


def test_gill_online_cancel(cores, want, monkeypatch):
    """cancel() on the GILL engine: a queued request completes empty; one in
    flight returns its streamed valid prefix (taps stay None) at the chunk
    boundary where the cancel lands (the scheduler parks inside chunk 2
    while the test cancels: the prefill token and two chunks); the other
    slot's request is untouched; the freed slot serves new work; a
    finished handle is unaffected."""
    rng = np.random.RandomState(9)
    embs = _embs(rng, 6)
    full = want([(embs, 30, 1.0)])[0]["tokens"]
    short = want([(embs, 4, 1.0)])[0]["tokens"]
    online = _online(cores)
    eng = online.eng
    parked, go = threading.Event(), threading.Event()
    orig, calls = eng._run_chunk, [0]

    def gated():
        calls[0] += 1
        if calls[0] == 2:
            parked.set()
            assert go.wait(WAIT)
        return orig()

    monkeypatch.setattr(eng, "_run_chunk", gated)
    try:
        a = online.submit(embs, 30)
        b = online.submit(embs, 30)       # the second slot
        it = a.stream()
        first = next(it)                  # chunk 1 landed: a is in flight
        assert parked.wait(WAIT)          # the scheduler is inside chunk 2
        c = online.submit(embs, 4)        # queued (two slots)
        c.cancel()
        a.cancel()
        go.set()
        assert c.result(timeout=WAIT) == [] and c.cancelled
        got = a.result(timeout=WAIT)
        assert [first] + list(it) == got
        assert got == full[:1 + 2 * eng.chunk]
        assert a.img_hidden is None and a.img_runs is None
        assert b.result(timeout=WAIT) == full
        d = online.submit(embs, 4)
        assert d.result(timeout=WAIT) == short
        d.cancel()                        # cancel after completion: no-op
        assert d.result(timeout=WAIT) == short
        assert eng.stats["cancelled"] == 2
    finally:
        go.set()
        online.close()


def test_gill_online_prefix_caching_matches(cores, want):
    """register_prefix rides the scheduler thread; suffix-only prefixed
    submissions give gill_tpu's tokens and taps for the same prefixed
    requests and count hits; bad references fail the caller."""
    rng = np.random.RandomState(7)
    prefix = _embs(rng, 9)
    suffixes = [_embs(rng, int(rng.randint(1, 7))) for _ in range(4)]
    batch = want([(sfx, 5, 100.0) for sfx in suffixes], prefix=prefix)
    online = _online(cores)
    try:
        pid = online.register_prefix(prefix)
        with pytest.raises(ValueError, match="unknown prefix_id"):
            online.submit(suffixes[0], 2, prefix_id=pid + 1)
        with pytest.raises(ValueError, match="prefix embs must be"):
            online.register_prefix(np.zeros((3,), np.float32))
        handles = [online.submit(sfx, 5, img_scale=100.0, prefix_id=pid)
                   for sfx in suffixes]
        for i, h in enumerate(handles):
            assert h.result(timeout=WAIT) == batch[i]["tokens"], f"req {i}"
            np.testing.assert_allclose(h.img_hidden, batch[i]["img_hidden"],
                                       atol=TAP_ATOL)
        assert online.eng.stats["prefix_hits"] == len(suffixes)
        # extend: [prefix[:4]] + prefix[4:] serves what prefix serves
        p0 = online.register_prefix(prefix[:4])
        p1 = online.extend_prefix(p0, prefix[4:])
        h = online.submit(suffixes[0], 5, img_scale=100.0, prefix_id=p1)
        assert h.result(timeout=WAIT) == batch[0]["tokens"]
        online.drop_prefix(p0)
        with pytest.raises(RuntimeError, match="unknown prefix_id"):
            online.extend_prefix(p0, prefix[:2])
    finally:
        online.close()


def test_http_gill_route_end_to_end(api):
    """/v1/gill runs the whole pipeline (decode, [IMG], mapper, SD) for
    concurrent requests; captions and routes are gill_tpu's async API's on
    the same checkpoint (its SD off: its images come from its own random
    stream). Bad requests get 400."""
    jm, tm = api
    b64 = _b64(_image())
    bodies = [
        {"prompts": [{"image_b64": b64}, "Q: what?\nA:"], "num_words": 3,
         "gen_scale_factor": 1e6, "num_inference_steps": 2},
        {"prompts": ["a photo of"], "num_words": 3, "gen_scale_factor": 1e6,
         "num_inference_steps": 2},
        # two [IMG] runs through the tap ring (max_num_rets 2)
        {"prompts": ["two pictures of"], "num_words": 3,
         "gen_scale_factor": 1e6, "num_inference_steps": 2,
         "max_num_rets": 2},
        {"prompts": ["A picture of"], "num_words": 5, "min_word_tokens": 5},
    ]
    jsd, jm.sd_pipe = jm.sd_pipe, None
    try:
        expect = []
        for b in bodies:
            prompts = [_image() if isinstance(p, dict) else p
                       for p in b["prompts"]]
            rets = b.get("max_num_rets", 1)
            h = jm.generate_async(
                prompts, num_words=b["num_words"],
                min_word_tokens=b.get("min_word_tokens", 0),
                gen_scale_factor=b.get("gen_scale_factor", 1.0),
                max_num_rets=rets)
            expect.append(jm.finalize_async(h, max_num_rets=rets))
    finally:
        jm.sd_pipe = jsd
    srv = make_server(gill=tm, port=0)
    base = _serve(srv)
    try:
        results = [None] * len(bodies)

        def post(i):
            results[i] = _post(f"{base}/v1/gill", bodies[i])["outputs"]

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
        for got, exp in zip(results, expect):
            _same_route(got, exp)
            for d in got:
                if isinstance(d, dict):
                    png = base64.b64decode(d["gen"][0]["image_b64"])
                    assert Image.open(io.BytesIO(png)).size == (16, 16)
        assert results[0][0].endswith("[IMG0][IMG1][IMG2][IMG3]")
        assert sum(isinstance(x, dict) for x in results[2]) == 2
        assert isinstance(results[3][0], str) and len(results[3]) == 1
        with urllib.request.urlopen(f"{base}/stats", timeout=WAIT) as r:
            stats = json.loads(r.read())
        assert sum(s["tokens_out"] for s in stats["gill"].values()) > 0

        for body in ({}, {"prompts": [{"image_b64": base64.b64encode(
                b"definitely not a PNG").decode()}], "num_words": 2}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/v1/gill", body)
            assert e.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()


def test_http_gill_prefix_route(api):
    """/v1/gill_prefix registers a conversation prefix; /v1/gill calls with
    its prefix_id and only the new turn give the full prompt's caption
    (and gill_tpu's). An unknown prefix gets 400, not a crash."""
    jm, tm = api
    srv = make_server(gill=tm, port=0)
    base = _serve(srv)
    history = ["You are a helpful assistant.\nQ: hi\nA: hello\n"]
    turn = ["Q: describe a dog\nA:"]
    try:
        full = _post(f"{base}/v1/gill", {"prompts": history + turn,
                                         "num_words": 4})["outputs"]
        pid = _post(f"{base}/v1/gill_prefix",
                    {"prompts": history})["prefix_id"]
        cached = _post(f"{base}/v1/gill", {"prompts": turn, "num_words": 4,
                                           "prefix_id": pid})["outputs"]
        assert cached[0] == full[0]
        jpid = jm.register_prefix_async(history)
        jout = jm.finalize_async(jm.generate_async(turn, num_words=4,
                                                   prefix_id=jpid))
        assert cached[0] == jout[0]
        eng = tm._online_engines[(4, 8, 512, False, 1)].eng
        assert eng.stats["prefix_hits"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/gill", {"prompts": turn, "num_words": 4,
                                      "prefix_id": pid + 7})
        assert e.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()


def test_http_gill_prefix_extend_incremental_chat(api):
    """Incremental chat over HTTP: register turn 1's history, extend it by
    turn 2's exchange, and turn 3 decodes what a registration of the whole
    history gives; a dropped prefix cannot be extended (400)."""
    _, tm = api
    srv = make_server(gill=tm, port=0)
    base = _serve(srv)
    h1 = ["Q: one\nA: yes\n"]
    h2 = ["Q: two\nA: maybe\n"]
    turn = ["Q: three\nA:"]
    try:
        pid_full = _post(f"{base}/v1/gill_prefix",
                         {"prompts": h1 + h2})["prefix_id"]
        expect = _post(f"{base}/v1/gill", {"prompts": turn, "num_words": 4,
                                           "prefix_id": pid_full})["outputs"]
        pid0 = _post(f"{base}/v1/gill_prefix", {"prompts": h1})["prefix_id"]
        pid1 = _post(f"{base}/v1/gill_prefix",
                     {"extend": pid0, "prompts": h2})["prefix_id"]
        got = _post(f"{base}/v1/gill", {"prompts": turn, "num_words": 4,
                                        "prefix_id": pid1})["outputs"]
        assert got[0] == expect[0]
        assert _post(f"{base}/v1/gill_prefix", {"drop": pid0}) == {"ok": True}
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/gill_prefix", {"extend": pid0, "prompts": h2})
        assert e.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("route", ["text", "img"])
def test_generate_async_finalize_matches_gill_tpu(api, route):
    """generate_async -> finalize_async on both packages, three concurrent
    requests: the same tokens, captions and route. [IMG]: retrieval, the
    decision MLP and GILLMapper with SD off on both sides, so the
    generation embeddings are compared (1e-4 relative, as
    tests/test_torch_gill_e2e.py holds them)."""
    jm, tm = api
    prompts = [[_image(), "Q: hi\nA:"], ["A picture of"], ["x y"]]
    kw = (dict(num_words=6, min_word_tokens=6) if route == "text" else
          dict(num_words=3, gen_scale_factor=1e6))
    sds = jm.sd_pipe, tm.sd_pipe
    jm.sd_pipe = tm.sd_pipe = None
    try:
        jh = [jm.generate_async(p, **kw) for p in prompts]
        th = [tm.generate_async(p, **kw) for p in prompts]
        for j, t in zip(jh, th):
            assert t.result(timeout=WAIT) == [int(x) for x in
                                              j.result(timeout=WAIT)]
        got = [tm.finalize_async(t) for t in th]
        expect = [jm.finalize_async(j) for j in jh]
    finally:
        jm.sd_pipe, tm.sd_pipe = sds
    for g, w in zip(got, expect):
        _same_route(g, w)
        if route == "img":
            assert g[0].endswith("[IMG0][IMG1][IMG2][IMG3]")
            gen, want_gen = g[1]["gen"][0], np.asarray(w[1]["gen"][0])
            np.testing.assert_allclose(gen, want_gen, rtol=1e-4,
                                       atol=1e-4 * np.abs(want_gen).max())
        else:
            assert len(g) == 1 and isinstance(g[0], str)


def test_encode_prompts_add_bos_false_matches_gill_tpu(api):
    """add_bos=False (a suffix continuing a registered prefix): no BOS on
    the first text, ids equal to gill_tpu's, embeddings to 1e-5."""
    jm, tm = api
    prompts = ["Q: more\nA:", _image(), "and then"]
    for add_bos in (True, False):
        jembs, jids = jm._encode_prompts(prompts, add_bos=add_bos)
        tembs, tids = tm._encode_prompts(prompts, add_bos=add_bos)
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_allclose(tembs.numpy(), np.asarray(jembs),
                                   rtol=1e-5, atol=1e-5)
        assert (tids[0, 0] == tm.tokenizer.bos_token_id) == add_bos
