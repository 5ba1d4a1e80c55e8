"""Measures prefix caching on a chat-shaped trace on the card.

Port of scripts/profile_prefix.py. Every request shares one system-prompt
prefix plus a short suffix of its own, the shape prefix caching exists
for. Two runs over the same requests:

  plain : every prefill computes prefix + suffix at the full bucket;
  prefix: `register_prefix()` once, then suffix-only prefills at the
          prefix's offset (the original's `_prefix_prefill_fn`; here
          DecodeEngine's `_prefill` with the cached rows).

Each prints its host-clock seconds, tokens/s and prefill counts, then the
speedup. The two runs' generated tokens must be equal, or each request's
first divergence a near-tie of the card's bf16 rounding
(`_serving.TIE_RTOL`; a row with "failed" otherwise). The flags stand for
GILL_PFX_MODEL / _LEN / _SFX / _NREQ / _NEW / _SLOTS; the model is
`init_dummy`'s zero OPT in W8. Nothing is written without --out.

    python -m gill_tpu_torch.scripts.profile_prefix [--model NAME]
        [--prefix-len 192] [--suffix-len 32] [--nreq 48] [--new 64]
        [--slots 16] [--device cuda] [--out PATH]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gill_tpu_torch.scripts import _serving as S
from gill_tpu_torch.scripts._timing import clock_note, probe_main, wall_ms
from gill_tpu_torch.serve.engine import DecodeEngine, ServeRequest

FLAGS = [("model", str, "OPT preset (default facebook/opt-2.7b)"),
         ("prefix_len", int, "shared prefix tokens (192)"),
         ("suffix_len", int, "each request's own tokens (32)"),
         ("nreq", int, "requests (48)"), ("new", int, "tokens a request (64)"),
         ("slots", int, "decode slots (16)")]


def chat_trace(prefix_len, suffix_len, nreq):
    """(prefix, suffixes): random ids 2..999 from RandomState(0)."""
    rng = np.random.RandomState(0)
    prefix = rng.randint(2, 1000, size=prefix_len).tolist()
    return prefix, [rng.randint(2, 1000, size=suffix_len).tolist()
                    for _ in range(nreq)]


@torch.no_grad()
def probe(model=S.MODEL, prefix_len=192, suffix_len=32, nreq=48, new=64,
          slots=16, chunk=32, buckets=(32, 64, 128, 256, 512),
          device="cuda", params=None):
    print(clock_note(device), flush=True)
    params, cfg = S.w8_lm(model, device, params)
    prefix, suffixes = chat_trace(prefix_len, suffix_len, nreq)
    max_seq = 1
    while max_seq < prefix_len + suffix_len + new:
        max_seq *= 2

    def run(use_prefix: bool):
        eng = DecodeEngine(params, cfg, slots=slots, max_seq=max_seq,
                           chunk=chunk, prefill_buckets=buckets,
                           kv_dtype=S.act_dtype(device))
        pid = eng.register_prefix(prefix) if use_prefix else None
        reqs = [ServeRequest(uid=i, prompt=prefix + sfx, max_new_tokens=new,
                             prefix_id=pid) for i, sfx in enumerate(suffixes)]
        eng.warmup()
        # the live prefill shapes once, outside the timed run
        eng.run([ServeRequest(uid=10 ** 6 + i, prompt=prefix + suffixes[0],
                              max_new_tokens=1, prefix_id=pid)
                 for i in range(slots)])
        out = {}
        dt = wall_ms(lambda: out.update(eng.run(reqs)), device) / 1e3
        return dt, dict(eng.stats), out

    print(f"model={S.model_name(model)} prefix={prefix_len} "
          f"suffix={suffix_len} new={new} nreq={nreq} slots={slots} "
          f"max_seq={max_seq}", flush=True)
    dt_plain, st_plain, out_plain = run(False)
    dt_pfx, st_pfx, out_pfx = run(True)
    tok = nreq * new
    print(f"plain : {dt_plain:.2f}s  {tok / dt_plain:8.1f} tok/s  "
          f"prefills={st_plain['prefills']}", flush=True)
    print(f"prefix: {dt_pfx:.2f}s  {tok / dt_pfx:8.1f} tok/s  "
          f"prefills={st_pfx['prefills']}  hits={st_pfx['prefix_hits']}  "
          f"saved={st_pfx['prefix_tokens_saved']} prefill tokens",
          flush=True)
    print(f"speedup: {dt_plain / dt_pfx:.3f}x", flush=True)
    full = all(len(v) == new for o in (out_plain, out_pfx)
               for v in o.values())
    equal = out_plain == out_pfx
    div = S.token_divergences(params, cfg, out_pfx, out_plain, {
        i: prefix + sfx for i, sfx in enumerate(suffixes)})
    row = {"model": S.model_name(model), "prefix": prefix_len,
           "suffix": suffix_len, "new": new, "nreq": nreq, "slots": slots,
           "max_seq": max_seq, "plain_s": dt_plain,
           "plain_tok_s": tok / dt_plain, "plain_prefills":
           st_plain["prefills"], "prefix_s": dt_pfx,
           "prefix_tok_s": tok / dt_pfx, "prefix_prefills":
           st_pfx["prefills"], "prefix_hits": st_pfx["prefix_hits"],
           "prefix_tokens_saved": st_pfx["prefix_tokens_saved"],
           "speedup": dt_plain / dt_pfx, "tokens_equal": equal,
           "divergences": div, "tokens": out_pfx}
    bad = S.unexplained(div)
    print(f"tokens equal: {equal}" + ("" if equal else f" (divergences: "
                                      f"{div})")
          + ("" if full and not bad else "  FAILED"), flush=True)
    if not full:
        row["failed"] = "a request is short"
    elif bad:
        row["failed"] = ("the prefix run's tokens differ from the plain "
                         "run's away from a near-tie")
    return [row]


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(probe, __doc__, argv, device, FLAGS, **kw)


if __name__ == "__main__":
    sys.exit(main())
