"""The ported serving and block probes (gill_tpu_torch/scripts/profile_serve,
profile_gill_serve, profile_serve_sched, profile_prefix,
profile_chat_extend, profile_decode, profile_opt67,
profile_serve_prefix_decode, flash_blockk_probe, attn_pack_probe) on the
CPU at tiny shapes, where the kernels take their plain versions.

Each measuring function runs through its `main(["--out", PATH])` once (a
module fixture, one intra-op thread) and prints the original's rows under
the original's names; --out writes the rows, and nothing else is written. The equalities the probes check are
also held against gill_tpu's engines on carried-over fp32 parameters,
EXACTLY (greedy tokens): profile_prefix's prefix run against gill_tpu's
prefix-cached DecodeEngine, profile_chat_extend's incremental turns
against gill_tpu's GillDecodeEngine extending the same session, and
profile_serve_prefix_decode's tokens against gill_tpu's run_pipelined.
"""

import io
import json
import os
from contextlib import redirect_stdout

import jax.numpy as jnp
import pytest
import torch

from gill_tpu.config import OPTConfig as JOPTConfig
from gill_tpu.serve.engine import DecodeEngine as JEngine
from gill_tpu.serve.engine import ServeRequest as JRequest
from gill_tpu.serve.gill_engine import GillDecodeEngine as JGEngine
from gill_tpu.serve.gill_engine import GillServeRequest as JGRequest
from gill_tpu_torch import config as tcfg
from gill_tpu_torch.models import opt as topt
from gill_tpu_torch.models.gill import GILLCore
from gill_tpu_torch.scripts import (_serving, attn_pack_probe,
                                    flash_blockk_probe, profile_chat_extend,
                                    profile_decode, profile_gill_serve,
                                    profile_opt67, profile_prefix,
                                    profile_serve, profile_serve_prefix_decode,
                                    profile_serve_sched)
from gill_tpu_torch.nn.core import Init
from gill_tpu_torch.weights.from_jax import tree_to_numpy

from test_gill_forward import make_core

OPT = dict(num_layers=2, hidden_size=64, ffn_dim=128, num_heads=4,
           vocab_size=1024, max_positions=512, word_embed_proj_dim=64)
T = tcfg.OPTConfig(**OPT)
# K6's head dim (128): profile_serve_prefix_decode's phase 1, cut
D128 = dict(num_layers=2, hidden_size=256, ffn_dim=256, num_heads=2,
            vocab_size=1024, max_positions=640, word_embed_proj_dim=256)
LM = dict(slots=4, max_seq=64, buckets=(16, 32))
PREFIX = dict(prefix_len=12, suffix_len=4, nreq=6, new=5, slots=4, chunk=4,
              buckets=(8, 16, 32))
CHAT = dict(turns=3, turn_rows=4, new_tok=3, slots=2, max_seq=128, chunk=4,
            buckets=(8, 32, 64), passes=1)
TINY_ENGINE = (4, 64, 4, (16, 32))

TINY = {
    "profile_serve": (profile_serve, dict(
        model=T, chunk=4, pos=20, n_chunk=2, n_prefill=1, n_round_trip=2,
        **LM)),
    "profile_gill_serve": (profile_gill_serve, dict(
        model=T, chunk=4, wave=(4, 32), pos=20, n_chunk=2, n_wave=1, **LM)),
    "profile_serve_sched": (profile_serve_sched, dict(
        model=T, chunks=(4,), nreq=6, prompt=(4, 20), gen=(2, 10), **LM)),
    "profile_prefix": (profile_prefix, dict(model=T, **PREFIX)),
    "profile_chat_extend": (profile_chat_extend, dict(model=T, **CHAT)),
    "profile_decode": (profile_decode, dict(model=T, batch=2, prompt=4,
                                            gen=3)),
    "profile_opt67": (profile_opt67, dict(model=T, batch=2, prompt=4,
                                          gen=2)),
    "profile_serve_prefix_decode": (profile_serve_prefix_decode, dict(
        tiny_cfg=tcfg.OPTConfig(**D128), tiny_engine=TINY_ENGINE,
        tiny_reqs=profile_serve_prefix_decode.tiny_requests(
            4, prompt=(4, 30), gen=(2, 8)),
        model=T, engine=TINY_ENGINE,
        traces={"mixed": _serving.serve_trace(4, prompt=(4, 20),
                                              gen=(2, 8))})),
    "flash_blockk_probe": (flash_blockk_probe, dict(shape=(1, 64, 2, 40),
                                                    n1=1, n2=2)),
    "attn_pack_probe": (attn_pack_probe, dict(shape=(1, 64, 2, 40),
                                              n_lo=1, n_hi=2)),
}

# each probe's lines after the clock note: the original's names
LINES = {
    "profile_serve": ["chunk(4 steps, 4 slots): ", "prefill bucket 16 x 1 ",
                      "prefill bucket 16 x 4 ", "prefill bucket 32 x 1 ",
                      "prefill bucket 32 x 4 ",
                      "bare dispatch+sync round-trip: "],
    "profile_gill_serve": ["gill chunk (4 steps): ",
                           "gill prefill wave (4x32): ",
                           "  embs host->device (", "plain chunk (4 steps): "],
    "profile_serve_sched": ["chunk=  4 depth=2  sync ",
                            "chunk=  4 depth=3  sync "],
    "profile_prefix": ["model=custom prefix=12 suffix=4 new=5 nreq=6 slots=4 "
                       "max_seq=32", "plain : ", "prefix: ", "speedup: ",
                       "tokens equal: True"],
    "profile_decode": ["baseline ", "w/o attn-core ", "w/o cache-upd ",
                       "w/o whole-attn ", "w/o mlp ", "w/o lm-head "],
    "profile_opt67": ["device time: not measured"],
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: its tiny ops are launch
    overhead, which the suite's parallel workers otherwise multiply."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_tree(init_fn, seed):
    """A tree from the port's init (`init_fn(Init)`), and the same as numpy
    in gill_tpu's layout for gill_tpu's engines."""
    tree = init_fn(Init(torch.Generator().manual_seed(seed), "cpu"))
    return tree, tree_to_numpy(tree)


@pytest.fixture(scope="module")
def trees():
    """fp32 parameters carried into both packages: the tiny OPT, the d-128
    OPT of profile_serve_prefix_decode's phase 1, and a tiny GILL."""
    core = make_core()
    tcore = GILLCore(
        cfg=tcfg.GILLConfig(**core.cfg.__dict__),
        opt_cfg=tcfg.OPTConfig(**core.opt_cfg.__dict__),
        vis_cfg=tcfg.CLIPVisionConfig(**core.vis_cfg.__dict__),
        vocab_len=core.vocab_len, img_start=core.img_start,
        pad_token_id=core.pad_token_id, bos_token_id=core.bos_token_id)
    return {"opt": _port_tree(lambda i: topt.init(i, T), 11),
            "d128": _port_tree(lambda i: topt.init(
                i, tcfg.OPTConfig(**D128)), 5),
            "gill": (core, tcore) + _port_tree(tcore.init_params, 3)}


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    """Every probe's `main(["--out", PATH])` once at tiny shapes, in an
    empty working directory: {name: (exit code, printed lines, rows from
    the JSON, the directory's files)}. profile_prefix, profile_chat_extend
    and profile_serve_prefix_decode run on the carried-over trees, whose
    tokens the gill_tpu tests below hold."""
    extra = {"profile_prefix": dict(params=trees["opt"][0]),
             "profile_chat_extend": dict(model=None, core=trees["gill"][1],
                                         params=trees["gill"][2]),
             "profile_serve_prefix_decode": dict(
                 tiny_params=trees["d128"][0])}
    out = {}
    for name, (mod, kw) in TINY.items():
        d = tmp_path_factory.mktemp(name)
        buf, cwd = io.StringIO(), os.getcwd()
        os.chdir(d)
        try:
            with redirect_stdout(buf):
                rc = mod.main(["--out", str(d / "rows.json")], device="cpu",
                              **{**kw, **extra.get(name, {})})
        finally:
            os.chdir(cwd)
        out[name] = (rc, buf.getvalue().splitlines(),
                     json.loads((d / "rows.json").read_text()),
                     sorted(os.listdir(d)))
    return out


@pytest.mark.parametrize("name", sorted(TINY))
def test_probe_rows_and_out(name, runs):
    """Exit 0, the original's lines, the rows as JSON at --out, and no
    other file (the originals write their JSON into the working
    directory)."""
    rc, lines, rows, files = runs[name]
    assert rc == 0 and files == ["rows.json"]
    assert lines[0].startswith("# device: cpu")
    if name in LINES:
        body = [ln for ln in lines[1:] if ln.strip() and "USDT" not in ln]
        for want in LINES[name]:
            assert any(ln.startswith(want) for ln in body), (want, body)
    assert isinstance(rows, list) and rows
    assert not any("failed" in r for r in rows)


def test_json_line_probes_follow_the_originals(runs):
    """chat_extend's per-turn keys, prefix_decode's two phases, the block
    probe's tiles (every pair of MMA_TILES, auto, SDPA, plain) and the pack
    probe's layouts, each within bf16 rounding of the plain version."""
    turns = [json.loads(ln) for ln in runs["profile_chat_extend"][1][1:]]
    assert [list(t) for t in turns] == [["history_rows", "incremental_ms",
                                         "cold_ms", "speedup",
                                         "tokens_equal"]] * CHAT["turns"]
    assert [t["history_rows"] for t in turns] == [11, 18, 25]
    recs = [json.loads(ln)
            for ln in runs["profile_serve_prefix_decode"][1][1:]]
    assert recs[0] == {"phase": "tiny", "tiny_token_match": True,
                       "requests_equal": 4, "requests": 4, "divergences": []}
    assert list(recs[1]) == ["mixed"]
    assert list(recs[1]["mixed"]) == ["phase", "trace", "off_tok_s",
                                      "on_tok_s", "speedup", "tokens_equal"]
    tiles = [json.loads(ln) for ln in runs["flash_blockk_probe"][1][1:]]
    assert [(t["block_q"], t["block_k"]) for t in tiles] == [
        (64, 64), (64, 128), (128, 64), (128, 128), ("auto(64)", "auto(64)"),
        ("sdpa", "sdpa"), ("plain", "plain")]
    assert all(t["max_err_vs_plain"] <= 2 ** -6 for t in tiles)
    layouts = [json.loads(ln) for ln in runs["attn_pack_probe"][1][1:]]
    assert [r["layout"] for r in layouts] == ["k2_d40", "padded_d128",
                                              "sdpa_d40", "plain_d40"]
    assert all(r["max_err_vs_plain"] <= 2 ** -6 for r in layouts)


def test_probe_flags_reach_the_measuring_function(capsys):
    """The originals' environment variables are flags: --chunks 4,2 runs
    two chunk sizes, --nreq 3 three requests; nothing is written without
    --out."""
    mod, kw = TINY["profile_serve_sched"]
    kw = {k: v for k, v in kw.items() if k not in ("chunks", "nreq")}
    assert mod.main(["--chunks", "4,2", "--nreq", "3"], device="cpu",
                    **kw) == 0
    rows = capsys.readouterr().out.splitlines()[1:]
    assert [r[:16] for r in rows] == ["chunk=  4 depth=", "chunk=  4 depth=",
                                      "chunk=  2 depth=", "chunk=  2 depth="]


def test_profile_decode_restores_the_layer_after_an_exception(monkeypatch):
    """An ablation's run raises: `models.opt._layer` is the original
    afterwards."""
    orig = topt._layer
    calls = []

    def flaky(fn, device, n=1):
        calls.append(topt._layer is orig)
        if len(calls) == 2:
            raise RuntimeError("a failing run")
        return 1.0

    monkeypatch.setattr(profile_decode, "wall_ms", flaky)
    with pytest.raises(RuntimeError, match="a failing run"):
        profile_decode.probe(model=T, batch=2, prompt=4, gen=2,
                             device="cpu")
    assert calls == [True, False]
    assert topt._layer is orig


def test_divergences_are_measured_at_the_first_difference(trees):
    """Where two runs' tokens differ, the probes measure the top-2 logit
    gap after the shared sequence (one plain forward) and fail the row
    only above TIE_RTOL."""
    tp = trees["opt"][0]
    prompt = [5, 6, 7]
    a = {0: [9, 10, 11], 1: [4, 4]}
    b = {0: [9, 12], 1: [4, 4]}
    (div,) = _serving.token_divergences(tp, T, a, b, {0: prompt, 1: [8]})
    assert div["uid"] == 0 and div["at"] == 1
    want = topt.forward(tp, T, topt.embed_tokens(
        tp, torch.tensor([prompt + [9]])))["logits"][0, -1]
    top = torch.topk(want, 2).values
    assert div["margin"] == pytest.approx(float(
        (top[0] - top[1]) / want.abs().max()), rel=1e-6)
    assert _serving.unexplained([dict(div, margin=_serving.TIE_RTOL)]) == []
    assert _serving.unexplained([dict(div, margin=0.5)]) != []


# ---------------------------------------------------------------------------
# the probes' equalities against gill_tpu's engines
# ---------------------------------------------------------------------------

def _tokens(rows_tokens) -> dict:
    return {int(u): v for u, v in rows_tokens.items()}


def test_profile_prefix_tokens_match_gill_tpu(runs, trees):
    (row,) = runs["profile_prefix"][2]
    assert row["tokens_equal"] and "failed" not in row
    prefix, suffixes = profile_prefix.chat_trace(
        PREFIX["prefix_len"], PREFIX["suffix_len"], PREFIX["nreq"])
    je = JEngine(trees["opt"][1], JOPTConfig(**OPT), slots=PREFIX["slots"],
                 max_seq=row["max_seq"], chunk=PREFIX["chunk"],
                 prefill_buckets=PREFIX["buckets"], unroll_layers=False,
                 kv_dtype=jnp.float32)
    pid = je.register_prefix(prefix)
    want = je.run([JRequest(uid=i, prompt=prefix + s,
                            max_new_tokens=PREFIX["new"], prefix_id=pid)
                   for i, s in enumerate(suffixes)])
    assert _tokens(row["tokens"]) == want
    assert len({tuple(v) for v in want.values()}) > 1   # not a constant


def test_profile_chat_extend_turns_match_gill_tpu(runs, trees):
    rows = runs["profile_chat_extend"][2]
    assert all(r["tokens_equal"] and "failed" not in r for r in rows)
    core, jp = trees["gill"][0], trees["gill"][3]
    first, turns, folds = profile_chat_extend.session(
        core.opt_cfg.word_embed_proj_dim, CHAT["turns"], CHAT["turn_rows"],
        CHAT["new_tok"])
    je = JGEngine(core, jp, slots=CHAT["slots"], max_seq=CHAT["max_seq"],
                  chunk=CHAT["chunk"], prefill_buckets=CHAT["buckets"],
                  unroll_layers=False, kv_dtype=jnp.float32)
    pid = je.register_prefix(first)
    for t, (turn, fold) in enumerate(zip(turns, folds)):
        out = je.run([JGRequest(uid=t, embs=turn,
                                num_words=CHAT["new_tok"], prefix_id=pid)])
        assert rows[t]["tokens"] == out[t]["tokens"], t
        pid = je.extend_prefix(pid, fold)


def test_profile_serve_prefix_decode_tokens_match_gill_tpu(runs, trees):
    row = runs["profile_serve_prefix_decode"][2][0]
    assert row["tiny_token_match"] and "failed" not in row
    slots, max_seq, chunk, buckets = TINY_ENGINE
    je = JEngine(trees["d128"][1], JOPTConfig(**D128), slots=slots,
                 max_seq=max_seq, chunk=chunk, prefill_buckets=buckets,
                 unroll_layers=False, kv_dtype=jnp.float32)
    reqs = TINY["profile_serve_prefix_decode"][1]["tiny_reqs"]
    want = je.run_pipelined([JRequest(uid=r.uid, prompt=r.prompt,
                                      max_new_tokens=r.max_new_tokens)
                             for r in reqs])
    assert _tokens(row["tokens"]) == want
