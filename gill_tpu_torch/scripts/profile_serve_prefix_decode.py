"""The valid-prefix decode kernel (K6) in the serving engines against the
plain decode path, on the card.

Port of scripts/profile_serve_prefix_decode.py. The serving engines' (B,)
positions reach ops/attention.py's dispatcher, which takes K6
(csrc/decode_attn.cu: each row's valid prefix only) wherever
`prefix_decode_eligible` allows, and otherwise the plain decode path
(`_decode_attention`: the whole read window). `k6_off()` swaps that gate
for one that refuses, as chip_smoke.py's `plain_kernels()` swaps a
kernel, and restores it in a `finally`. gill_tpu turns its kernel on with
an import-time threshold (GILL_PREFIX_DECODE_MIN) and so runs each side in
a subprocess; the port has no such threshold, and both sides run in this
process. Two phases:
  1. tokens: a d-128 config (vocab 512, hidden 1024, 4 layers, 8 heads),
     random N(0, 0.05) weights in bf16 from a seeded generator, 24
     requests (RandomState(3): prompts U[8, 200), generations U[8, 96)),
     `run_pipelined` with K6 and without: the tokens must be equal, or
     each request's first divergence a near-tie of bf16 rounding
     (`_serving.TIE_RTOL`; a row with "failed" otherwise);
  2. speed: OPT-6.7B in W8 (`init_dummy`'s zero tree), 16 slots, max_seq
     512, chunk 32, the "mixed" trace (bench_serve's 48 requests) and the
     "deep" one (32 requests of 240-token prompts and 192 new tokens),
     tokens/s on the host clock with K6 and without.
The original writes SERVE_PREFIX_DECODE_PROBE.json; nothing is written
here without --out.

    python -m gill_tpu_torch.scripts.profile_serve_prefix_decode
        [--phase all|tiny|perf] [--device cuda] [--out PATH]
"""

from __future__ import annotations

import contextlib
import json
import sys

import numpy as np
import torch

from gill_tpu_torch.config import OPTConfig
from gill_tpu_torch.models import opt as opt_mod
from gill_tpu_torch.nn.core import tree_map
from gill_tpu_torch.ops import attention as attn_mod
from gill_tpu_torch.scripts import _serving as S
from gill_tpu_torch.scripts._timing import clock_note, probe_main, wall_ms
from gill_tpu_torch.serve.engine import DecodeEngine, ServeRequest

TINY = OPTConfig(vocab_size=512, hidden_size=1024, num_layers=4,
                 num_heads=8, ffn_dim=2048, max_positions=640,
                 word_embed_proj_dim=1024)
FLAGS = [("phase", str, "all (default), tiny or perf")]


@contextlib.contextmanager
def k6_off():
    """The dispatcher's K6 gate refusing every call: the plain decode path."""
    saved = attn_mod.prefix_decode_eligible
    attn_mod.prefix_decode_eligible = lambda *a, **k: False
    try:
        yield
    finally:
        attn_mod.prefix_decode_eligible = saved


def random_tree(cfg, device, dtype, std=0.05, seed=0):
    """`init_dummy`'s structure with N(0, std) leaves from one generator."""
    g = torch.Generator(device).manual_seed(seed)
    return tree_map(lambda x: (torch.randn(x.shape, device=device,
                                           generator=g) * std).to(dtype),
                    opt_mod.init_dummy(cfg, dtype, device=device))


def tiny_requests(n=24, seed=3, prompt=(8, 200), gen=(8, 96)):
    rng = np.random.RandomState(seed)
    return [ServeRequest(uid=i, prompt=rng.randint(2, 500, size=int(
        rng.randint(*prompt))).tolist(), max_new_tokens=int(
            rng.randint(*gen))) for i in range(n)]


def deep_requests(n=32, seed=7, prompt=240, gen=192):
    rng = np.random.RandomState(seed)
    return [ServeRequest(uid=i, prompt=rng.randint(2, 1000, size=prompt)
                         .tolist(), max_new_tokens=gen) for i in range(n)]


def both_ways(eng, reqs):
    """run_pipelined with K6 and with the plain decode path: (tokens on,
    tokens off, host s on, host s off)."""
    on, off = {}, {}
    t_on = wall_ms(lambda: on.update(eng.run_pipelined(list(reqs))),
                   eng.device) / 1e3
    with k6_off():
        t_off = wall_ms(lambda: off.update(eng.run_pipelined(list(reqs))),
                        eng.device) / 1e3
    return on, off, t_on, t_off


@torch.no_grad()
def probe(phase="all", tiny_cfg=TINY, tiny_reqs=None, tiny_params=None,
          tiny_engine=(8, 512, 16, (64, 128, 256)), model="facebook/opt-6.7b",
          traces=None, engine=(16, 512, 32, (64, 128, 256)), device="cuda",
          params=None):
    """`traces`: {name: requests} for phase 2 (default mixed and deep);
    `tiny_engine` / `engine`: (slots, max_seq, chunk, buckets);
    `tiny_params`: phase 1's tree (default `random_tree`)."""
    print(clock_note(device), flush=True)
    dtype = S.act_dtype(device)
    rows = []
    if phase in ("tiny", "all"):
        slots, max_seq, chunk, buckets = tiny_engine
        if tiny_params is None:
            tiny_params = random_tree(tiny_cfg, device, dtype)
        eng = DecodeEngine(tiny_params, tiny_cfg,
                           slots=slots, max_seq=max_seq, chunk=chunk,
                           prefill_buckets=buckets, kv_dtype=dtype)
        reqs = tiny_reqs or tiny_requests()
        on, off, _, _ = both_ways(eng, reqs)
        div = S.token_divergences(tiny_params, tiny_cfg, on, off,
                                  {r.uid: r.prompt for r in reqs})
        row = {"phase": "tiny", "tiny_token_match": on == off,
               "requests_equal": len(on) - len(div), "requests": len(on),
               "divergences": div, "tokens": on}
        if S.unexplained(div):
            row["failed"] = ("K6's tokens differ from the plain decode "
                             "path's away from a near-tie")
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "tokens"}),
              flush=True)
        del eng
    if phase in ("perf", "all"):
        params, cfg = S.w8_lm(model, device, params)
        slots, max_seq, chunk, buckets = engine
        eng = DecodeEngine(params, cfg, slots=slots, max_seq=max_seq,
                           chunk=chunk, prefill_buckets=buckets,
                           kv_dtype=dtype)
        eng.warmup()
        eng.run(S.warm_requests(tuple(b - b // 4 for b in buckets)))
        for name, reqs in (traces or {"mixed": S.serve_trace(48),
                                      "deep": deep_requests()}).items():
            n_tok = sum(r.max_new_tokens for r in reqs)
            on, off, t_on, t_off = both_ways(eng, reqs)
            row = {"phase": "perf", "trace": name, "off_tok_s": n_tok / t_off,
                   "on_tok_s": n_tok / t_on, "speedup": t_off / t_on,
                   "tokens_equal": on == off}
            if sum(len(v) for v in on.values()) != n_tok:
                row["failed"] = "a request is short"
            rows.append(row)
            print(json.dumps({name: row}), flush=True)
    return rows


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(probe, __doc__, argv, device, FLAGS, **kw)


if __name__ == "__main__":
    sys.exit(main())
