"""Per-turn latency of a rolling chat session on the GILL serving engine,
on the card: incremental prefix extension (`extend_prefix`: prefill only
the new turn) against a cold prefill of the whole history each turn.

Port of scripts/profile_chat_extend.py: one session on a GILLCore over
`init_dummy`'s zero OPT in W8; a turn is 16 new embedding rows and 24
generated tokens, folded back into the history as 40 rows. The original
draws each mode's embeddings from one stream, so its two modes see
different turns; here both replay the same turns (drawn once from
RandomState(0)), so each turn's tokens must be equal between the modes,
or their first divergence a near-tie of the card's bf16 rounding
(`_serving.TIE_RTOL`; a row with "failed" otherwise). A first pass of
both modes warms the engine's shapes, the measured pass follows; one JSON
line a turn (history rows, incremental and cold host-clock ms, speedup).
--model stands for GILL_BENCH_MODEL. The original writes
CHAT_EXTEND_PROBE.json; nothing is written here without --out.

    python -m gill_tpu_torch.scripts.profile_chat_extend [--model NAME]
        [--turns 12] [--device cuda] [--out PATH]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from gill_tpu_torch.models import opt as opt_mod
from gill_tpu_torch.scripts import _serving as S
from gill_tpu_torch.scripts._timing import clock_note, probe_main, wall_ms
from gill_tpu_torch.serve.gill_engine import (GillDecodeEngine,
                                              GillServeRequest)

FLAGS = [("model", str, "OPT preset (default facebook/opt-2.7b)"),
         ("turns", int, "chat turns (12)")]


def session(e: int, turns: int, turn_rows: int, new_tok: int, seed=0):
    """(first turn, [turn embeddings], [folded turn + reply]) in fp32."""
    rng = np.random.RandomState(seed)

    def rows(n):
        return (rng.randn(n, e) * 0.02).astype(np.float32)
    return (rows(turn_rows), [rows(turn_rows) for _ in range(turns)],
            [rows(turn_rows + new_tok) for _ in range(turns)])


def incremental(eng, first, turns, folds, new_tok):
    """[(host ms, prefix rows after the turn, tokens)] a turn."""
    pid = eng.register_prefix(first)
    out = []
    for t, (turn, fold) in enumerate(zip(turns, folds)):
        res = {}

        def one():
            res.update(eng.run([GillServeRequest(uid=t, embs=turn,
                                                 num_words=new_tok,
                                                 prefix_id=pid)]))
            res["pid"] = eng.extend_prefix(pid, fold)
        ms = wall_ms(one, eng.device)
        eng.drop_prefix(pid)
        pid = res["pid"]
        out.append((ms, eng._prefixes[pid]["n"], res[t]["tokens"]))
    eng.drop_prefix(pid)
    return out


def cold(eng, first, turns, folds, new_tok):
    hist, out = first, []
    for t, (turn, fold) in enumerate(zip(turns, folds)):
        res = {}
        ms = wall_ms(lambda: res.update(eng.run([GillServeRequest(
            uid=t, embs=np.concatenate([hist, turn]),
            num_words=new_tok)])), eng.device)
        hist = np.concatenate([hist, fold])
        out.append((ms, hist.shape[0], res[t]["tokens"]))
    return out


def gill_tie_margin(eng, embs, toks) -> float:
    """`_serving.tie_margin` of the GILL engine's next-token logits after
    the prompt rows `embs` and the generated `toks` (one plain forward of
    the whole sequence, the [IMG]-merged head, [IMG1..n) banned as the
    engine's surgery bans them)."""
    dev, dtype = eng.device, eng.cache["k"].dtype
    x = torch.cat([torch.from_numpy(np.asarray(embs)).to(dev, dtype),
                   eng.params["embed_tokens"]["weight"][
                       torch.tensor(toks, dtype=torch.long, device=dev)]
                   .to(dtype)])
    logits = opt_mod.forward(eng.params, eng.cfg, x[None],
                             lm_head=eng._head)["logits"][0, -1].clone()
    logits[eng.img0 + 1:eng.img0 + eng.nt] = -torch.inf
    return S.tie_margin(logits)


@torch.no_grad()
def probe(model=S.MODEL, turns=12, turn_rows=16, new_tok=24, slots=4,
          max_seq=1024, chunk=16, buckets=(16, 64, 256, 512), passes=2,
          device="cuda", core=None, params=None):
    print(clock_note(device), flush=True)
    core, params = S.gill_model(model, device, core, params)
    eng = GillDecodeEngine(core, params, slots=slots, max_seq=max_seq,
                           chunk=chunk, prefill_buckets=buckets,
                           kv_dtype=S.act_dtype(device))
    eng.warmup()
    first, tv, fv = session(eng.emb_dim, turns, turn_rows, new_tok)
    for _ in range(passes):      # the last pass is the measured one
        inc = incremental(eng, first, tv, fv, new_tok)
        cld = cold(eng, first, tv, fv, new_tok)
    rows, hist = [], first
    for t, ((ti, _, toks_i), (tc, nc, toks_c)) in enumerate(zip(inc, cld)):
        row = {"history_rows": nc, "incremental_ms": ti, "cold_ms": tc,
               "speedup": tc / ti, "tokens_equal": toks_i == toks_c,
               "tokens": toks_i}
        if not row["tokens_equal"]:
            d = S.first_diff(toks_i, toks_c)
            row["divergence"] = {"at": d, "margin": gill_tie_margin(
                eng, np.concatenate([hist, tv[t]]), toks_i[:d])}
            if row["divergence"]["margin"] > S.TIE_RTOL:
                row["failed"] = "the incremental turn's tokens differ " \
                                "from the cold prefill's away from a " \
                                "near-tie"
        hist = np.concatenate([hist, fv[t]])
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "tokens"}),
              flush=True)
    return rows


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(probe, __doc__, argv, device, FLAGS, **kw)


if __name__ == "__main__":
    sys.exit(main())
