"""Whether serving speed is independent of the KV pool provisioned: the
serving engine's read-window ladder (`serve/engine.py kv_read_ladder`)
against the single full-pool read, at several pool depths (port of
scripts/profile_kv_window.py).

A decode chunk reads the pool through the smallest window of the ladder
(powers of two from 256 below max_seq, and max_seq) covering every slot's
position bound; with the ladder off it reads the whole pool. The claim to
measure: a pool built with max_seq 2048 for occasional long requests,
serving the ordinary bench trace (prompts U[16, 240], generations U[16,
192]), runs at the max_seq 512 rate. On the card K6 (the valid-prefix
decode attention) reads only each row's valid prefix whatever the window,
and plans for the pool the window spans (`decode_attn.plan_rows`).

Phases, each engine in a subprocess of its own (one engine a process
keeps the card's memory clean):
  1. tiny: a 4-layer random OPT, 8 slots, chunk 16, max_seq 1024, 24
     requests; the tokens with the ladder on must equal those with it off;
  2. perf: facebook/opt-2.7b in W8 (random weights made on the device),
     16 slots, chunk 32, the serve-bench trace; max_seq in --seqs x ladder
     {off, on}: tokens/s (host clock, warm), device ms a decode step (one
     profiled chunk of a refilled pool), K4's and K6's launches in the
     timed run and their shares of the chunk's device time, the mean
     window over max_seq; the tokens must be equal across the runs.

    python -m gill_tpu_torch.scripts.profile_kv_window [--phase all]
        [--seqs 512,1024,2048] [--nreq 48] [--model facebook/opt-2.7b]
        [--device cuda] [--out PATH]

It prints the card's name and power limit first and one JSON line a run,
and writes nothing without --out. `run_engine` is the measuring function
(chip_smoke.py calls it on its own tree); on the CPU it runs the plain
versions with no device time.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

from gill_tpu_torch.config import OPTConfig
from gill_tpu_torch.models import opt as opt_mod
from gill_tpu_torch.nn.core import Init, tree_map
from gill_tpu_torch.scripts import _serving as S
from gill_tpu_torch.scripts._timing import (clock_note, device_profile,
                                            smi_line, wall_ms)
from gill_tpu_torch.serve.engine import DecodeEngine, ServeRequest

TINY = dict(vocab_size=512, hidden_size=1024, num_layers=4, num_heads=8,
            ffn_dim=2048, max_positions=1024, word_embed_proj_dim=1024)
TINY_ENGINE = dict(slots=8, chunk=16, prefill_buckets=(64, 128, 256))
PERF_ENGINE = dict(slots=16, chunk=32, prefill_buckets=(64, 128, 256))


def _launches() -> dict:
    from gill_tpu_torch.ops import decode_attn, w8_matmul

    return {"k4": w8_matmul.w8_matmul.launches,
            "k6": decode_attn.prefix_decode_attention.launches}


def tiny_params(cfg: OPTConfig, device, seed: int = 0):
    """A random OPT tree (normal, std 0.05, every leaf) in the device's
    activation dtype."""
    g = torch.Generator(device).manual_seed(seed)
    p = opt_mod.init_dummy(cfg, S.act_dtype(device), device=device)
    return tree_map(lambda x: torch.randn(x.shape, generator=g, device=device,
                                          dtype=x.dtype) * 0.05, p)


def tiny_trace(n: int = 24, seed: int = 3, prompt=(8, 200), gen=(8, 96),
               vocab: int = 500):
    rng = np.random.RandomState(seed)
    return [ServeRequest(uid=i, prompt=rng.randint(
        2, vocab, size=int(rng.randint(*prompt))).tolist(),
        max_new_tokens=int(rng.randint(*gen))) for i in range(n)]


def perf_params(model: str, device, seed: int = 0):
    """`model` at full width with random weights made on the device from
    `seed`, its decoder linears in W8."""
    cfg = S.opt_cfg(model)
    g = torch.Generator(device).manual_seed(seed)
    params = opt_mod.init(Init(g, device, S.act_dtype(device)), cfg)
    return opt_mod.quantize_params_w8(params), cfg


def digest(tokens: dict) -> str:
    return hashlib.sha256(json.dumps(
        {str(u): tokens[u] for u in sorted(tokens)}).encode()).hexdigest()[:16]


@torch.no_grad()
def run_engine(params, cfg, reqs, *, max_seq: int, ladder: bool,
               slots: int, chunk: int, prefill_buckets, device,
               warmup: bool = True, warm_requests: bool = True,
               profile: bool = True) -> dict:
    """One engine over `reqs` (run_pipelined) at `max_seq` with the read
    ladder on or off, after `DecodeEngine.warmup()` and the originals'
    three short requests (each where asked): tokens, tokens/s, the mean
    window over max_seq, K4's and K6's launches in the run and, on the
    card with `profile`, one profiled chunk of a pool refilled with the
    trace's first `slots` requests: device ms a decode step and K4's and
    K6's shares of it (torch.profiler's pass over a chunk's ~70,000
    events takes tens of seconds of host time)."""
    eng = DecodeEngine(params, cfg, slots=slots, max_seq=max_seq,
                       chunk=chunk, prefill_buckets=prefill_buckets,
                       kv_read_buckets="auto" if ladder else None,
                       kv_dtype=S.act_dtype(device))
    if warmup:
        eng.warmup()
    if warm_requests:
        eng.run(S.warm_requests())
    n_tok = sum(r.max_new_tokens for r in reqs)
    s0, l0 = dict(eng.stats), _launches()
    out = {}
    ms = wall_ms(lambda: out.update(eng.run_pipelined(list(reqs))), device)
    l1 = _launches()
    chunks = eng.stats["chunks"] - s0["chunks"]
    rows_read = eng.stats["kv_rows_read"] - s0["kv_rows_read"]
    rep = {"max_seq": max_seq, "ladder": "on" if ladder else "off",
           "kv_ladder": list(eng.kv_buckets), "tokens_per_s":
           n_tok / (ms / 1e3), "wall_s": ms / 1e3, "generated": sum(
               len(v) for v in out.values()), "budget": n_tok,
           "mean_window_frac": rows_read / max(chunks, 1) / max_seq,
           "k4_launches": l1["k4"] - l0["k4"],
           "k6_launches": l1["k6"] - l0["k6"], "tokens_digest": digest(out),
           "device_ms_per_step": None, "k4_share": None, "k6_share": None}
    if profile and torch.device(device).type == "cuda":
        eng._reset_pool()
        eng._refill([ServeRequest(uid=r.uid, prompt=r.prompt,
                                  max_new_tokens=r.max_new_tokens)
                     for r in reqs[:slots]])
        prof = device_profile(lambda: eng._run_chunk().numpy(),
                              sums=("w8_", "prefix_decode"))
        busy = max(prof["busy_us"] or 0.0, 1e-9)
        rep["device_ms_per_step"] = busy / 1e3 / chunk
        rep["k4_share"] = prof["sum_us"]["w8_"] / busy
        rep["k6_share"] = prof["sum_us"]["prefix_decode"] / busy
    del eng
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    rep["tokens"] = out
    return rep


def _worker(argv) -> int:
    """One engine in this process: prints "RESULT <json>"."""
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("tiny", "perf"))
    ap.add_argument("max_seq", type=int)
    ap.add_argument("ladder", choices=("on", "off"))
    ap.add_argument("--model", default=S.MODEL)
    ap.add_argument("--nreq", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.mode == "tiny":
        cfg = OPTConfig(**TINY)
        params = tiny_params(cfg, a.device)
        reqs, kw = tiny_trace(), TINY_ENGINE
    else:
        params, cfg = perf_params(a.model, a.device)
        reqs, kw = S.serve_trace(a.nreq), PERF_ENGINE
    rep = run_engine(params, cfg, reqs, max_seq=a.max_seq,
                     ladder=a.ladder == "on", device=a.device, **kw)
    rep["tokens"] = {str(u): v for u, v in rep["tokens"].items()}
    print("RESULT " + json.dumps(rep), flush=True)
    return 0


def _spawn(mode: str, max_seq: int, ladder: str, args) -> dict:
    r = subprocess.run(
        [sys.executable, "-m", "gill_tpu_torch.scripts.profile_kv_window",
         "--worker", mode, str(max_seq), ladder, "--model", args.model,
         "--nreq", str(args.nreq), "--device", args.device],
        capture_output=True, text=True, timeout=2400)
    for line in r.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    return {"max_seq": max_seq, "ladder": ladder,
            "failed": f"worker exit {r.returncode}: {r.stderr[-1500:]}"}


def _print(tag: str, rep: dict):
    print(json.dumps({tag: {k: v for k, v in rep.items()
                            if k != "tokens"}}), flush=True)


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv[:1] == ["--worker"]:
        return _worker(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("tiny", "perf", "all"),
                    default="all")
    ap.add_argument("--seqs", default="512,1024,2048")
    ap.add_argument("--nreq", type=int, default=48)
    ap.add_argument("--model", default=S.MODEL)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the report as JSON here")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        print(smi_line(), flush=True)
    print(clock_note(args.device), flush=True)
    report, failed = {}, False
    if args.phase in ("tiny", "all"):
        runs = {g: _spawn("tiny", 1024, g, args) for g in ("off", "on")}
        ok = all("failed" not in r for r in runs.values())
        report["tiny_token_match"] = ok and \
            runs["off"]["tokens"] == runs["on"]["tokens"]
        failed |= not report["tiny_token_match"]
        print(json.dumps({"tiny_token_match": report["tiny_token_match"]}),
              flush=True)
    if args.phase in ("perf", "all") and not failed:
        tokens = None
        for max_seq in (int(s) for s in args.seqs.split(",")):
            ent = {}
            for gate in ("off", "on"):
                r = _spawn("perf", max_seq, gate, args)
                _print(f"s{max_seq}_{gate}", r)
                if "failed" in r:
                    failed = True
                    ent[gate] = r
                    continue
                toks = r.pop("tokens")
                r["tokens_equal_to_first_run"] = tokens is None or \
                    toks == tokens
                tokens = tokens or toks
                failed |= not r["tokens_equal_to_first_run"]
                ent[gate] = r
            if all("tokens_per_s" in ent.get(g, {}) for g in ("off", "on")):
                ent["speedup"] = (ent["on"]["tokens_per_s"]
                                  / ent["off"]["tokens_per_s"])
            report[f"seq{max_seq}"] = ent
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
