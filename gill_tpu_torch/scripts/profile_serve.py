"""Isolates the serving engine's cost components on the card.

Port of scripts/profile_serve.py: (a) the decode chunk alone at a steady
state (every slot busy at position 300), (b) one prefill per (bucket, wave
size), each waited for, (c) a bare launch + sync round trip (one tiny
kernel and a read of its result), so that the engine's end-to-end rate can
be set against its device work and the host's overhead. The original
times its jitted `_chunk_fn` / `_prefill_fn`; here DecodeEngine's own
`_chunk` and `_prefill`. Every time is the host clock around synchronised
work. The model is `init_dummy`'s zero OPT in W8 (the original's `q`
leaves); its flags stand for the original's GILL_BENCH_MODEL / _SLOTS /
_CHUNK. Nothing is written without --out.

    python -m gill_tpu_torch.scripts.profile_serve [--model NAME]
        [--slots 16] [--chunk 32] [--device cuda] [--out PATH]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gill_tpu_torch.scripts import _serving as S
from gill_tpu_torch.scripts._timing import clock_note, probe_main, wall_ms
from gill_tpu_torch.serve.engine import DecodeEngine

FLAGS = [("model", str, "OPT preset (default facebook/opt-2.7b)"),
         ("slots", int, "decode slots (16)"),
         ("chunk", int, "decode steps a chunk (32)")]


@torch.no_grad()
def probe(model=S.MODEL, slots=16, chunk=32, max_seq=512,
          buckets=(64, 128, 256), waves=None, pos=300, n_chunk=8,
          n_prefill=8, n_round_trip=20, device="cuda", params=None):
    print(clock_note(device), flush=True)
    params, cfg = S.w8_lm(model, device, params)
    eng = DecodeEngine(params, cfg, slots=slots, max_seq=max_seq,
                       chunk=chunk, prefill_buckets=buckets,
                       kv_dtype=S.act_dtype(device))
    eng.run(S.warm_requests(tuple(b - b // 4 for b in buckets)))
    rows = []

    # (a) the chunk alone, steady state
    S.steady_lm(eng, pos)
    eng._chunk(eng.max_seq)
    dt = wall_ms(lambda: eng._chunk(eng.max_seq), device, n_chunk)
    rows.append({"part": "chunk", "steps": chunk, "slots": slots, "ms": dt,
                 "ms_per_step": dt / chunk,
                 "tok_s": slots * chunk / (dt / 1e3)})
    print(f"chunk({chunk} steps, {slots} slots): {dt:.1f} ms "
          f"-> {dt / chunk:.2f} ms/step, {slots * chunk / (dt / 1e3):.0f} "
          f"tok/s", flush=True)

    # (b) one prefill per (bucket, wave size), each waited for
    for pb in buckets:
        for nreq in waves or dict.fromkeys((1, 4, slots)):
            args = (np.full((nreq, pb), 5, np.int32),
                    np.full((nreq,), pb, np.int32),
                    np.arange(nreq, dtype=np.int32),
                    np.full((nreq,), max_seq - 1, np.int32))
            eng._prefill(*args)
            dt = wall_ms(lambda: eng._prefill(*args), device, n_prefill)
            rows.append({"part": "prefill", "bucket": pb, "reqs": nreq,
                         "ms": dt, "ms_per_req": dt / nreq})
            print(f"prefill bucket {pb} x{nreq:2d} reqs: {dt:.1f} ms "
                  f"({dt / nreq:.1f} ms/req)", flush=True)

    # (c) a bare launch + sync round trip
    x = torch.zeros((), device=device)
    float(x + 1)
    dt = wall_ms(lambda: float(x + 1), device, n_round_trip)
    rows.append({"part": "round_trip", "ms": dt})
    print(f"bare dispatch+sync round-trip: {dt:.2f} ms", flush=True)
    return rows


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(probe, __doc__, argv, device, FLAGS, **kw)


if __name__ == "__main__":
    sys.exit(main())
