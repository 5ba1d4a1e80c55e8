"""Compares the serving schedulers on the card: the synchronous `run()`
against the asynchronous chunk pipeline `run_pipelined()` at depths 2 and
3, across chunk sizes.

Port of scripts/profile_serve_sched.py over the same trace
(bench_serve's: 48 requests, prompts U[16, 240], generations U[16, 192],
no EOS) on `init_dummy`'s zero OPT in W8. Each chunk size builds an
engine, warms it (`warmup()` and three short requests), then times `run`
and each `run_pipelined` on the host clock; the pipelined tokens must
equal run()'s (a row with "failed" otherwise). The flags stand for
GILL_BENCH_MODEL / _SLOTS, GILL_SCHED_CHUNKS and GILL_SCHED_NREQ. Nothing
is written without --out.

    python -m gill_tpu_torch.scripts.profile_serve_sched [--model NAME]
        [--slots 16] [--chunks 32,16,8] [--nreq 48] [--device cuda]
        [--out PATH]
"""

from __future__ import annotations

import sys

import torch

from gill_tpu_torch.scripts import _serving as S
from gill_tpu_torch.scripts._timing import clock_note, probe_main, wall_ms
from gill_tpu_torch.serve.engine import DecodeEngine


def _chunks(text: str):
    return tuple(int(c) for c in text.split(","))


FLAGS = [("model", str, "OPT preset (default facebook/opt-2.7b)"),
         ("slots", int, "decode slots (16)"),
         ("chunks", _chunks, "comma list of chunk sizes (32,16,8)"),
         ("nreq", int, "requests of the trace (48)")]


@torch.no_grad()
def probe(model=S.MODEL, slots=16, chunks=(32, 16, 8), nreq=48,
          max_seq=512, buckets=(64, 128, 256), prompt=(16, 241),
          gen=(16, 193), depths=(2, 3), device="cuda", params=None):
    print(clock_note(device), flush=True)
    params, cfg = S.w8_lm(model, device, params)
    reqs = S.serve_trace(nreq, prompt=prompt, gen=gen)
    n_tok = sum(r.max_new_tokens for r in reqs)
    rows = []
    for chunk in chunks:
        eng = DecodeEngine(params, cfg, slots=slots, max_seq=max_seq,
                           chunk=chunk, prefill_buckets=buckets,
                           kv_dtype=S.act_dtype(device))
        eng.warmup()
        eng.run(S.warm_requests(tuple(b - b // 4 for b in buckets)))
        out = {}
        dt_sync = wall_ms(lambda: out.update(eng.run(list(reqs))), device)
        if sum(len(v) for v in out.values()) != n_tok:
            rows.append({"chunk": chunk, "failed": "run() gave "
                         f"{sum(len(v) for v in out.values())} of {n_tok} "
                         "tokens"})
            print(f"FAILED chunk={chunk}: {rows[-1]['failed']}", flush=True)
            continue
        for depth in depths:
            outp = {}
            dt_p = wall_ms(lambda: outp.update(eng.run_pipelined(
                list(reqs), depth=depth)), device)
            row = {"chunk": chunk, "depth": depth,
                   "sync_tok_s": n_tok / (dt_sync / 1e3),
                   "pipelined_tok_s": n_tok / (dt_p / 1e3),
                   "tokens_equal": outp == out}
            if not row["tokens_equal"]:
                row["failed"] = "run_pipelined's tokens differ from run()'s"
            rows.append(row)
            print(f"chunk={chunk:3d} depth={depth}  sync "
                  f"{row['sync_tok_s']:7.1f} tok/s   pipelined "
                  f"{row['pipelined_tok_s']:7.1f} tok/s"
                  + ("" if row["tokens_equal"] else "  FAILED: tokens "
                     "differ"), flush=True)
        del eng
    return rows


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(probe, __doc__, argv, device, FLAGS, **kw)


if __name__ == "__main__":
    sys.exit(main())
