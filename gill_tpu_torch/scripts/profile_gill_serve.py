"""Attributes the GILL serving engine's cost on the card: the chunk against
the prefill wave and its host -> device copy, beside the plain-LM
engine's chunk at the same shape.

Port of scripts/profile_gill_serve.py: (a) GillDecodeEngine's chunk at a
steady state (every slot busy at position 300 with a budget no chunk
reaches), (b) a prefill wave of 16 requests x 256 embedding rows (all rows
dropped) from host arrays, and the embeddings' host -> device copy alone,
(c) DecodeEngine's chunk over the same LM and slots. The original times
its jitted `_chunk_fn` / `_prefill_fn`; here the engines' own `_chunk` and
`_prefill`, each on the host clock around synchronised work. The model is
a GILLCore over `init_dummy`'s zero OPT in W8 with the [IMG] rows
appended; the flags stand for GILL_BENCH_MODEL / _SLOTS / _CHUNK. Nothing
is written without --out.

    python -m gill_tpu_torch.scripts.profile_gill_serve [--model NAME]
        [--slots 16] [--chunk 32] [--device cuda] [--out PATH]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gill_tpu_torch.scripts import _serving as S
from gill_tpu_torch.scripts._timing import clock_note, probe_main, wall_ms
from gill_tpu_torch.serve.engine import DecodeEngine
from gill_tpu_torch.serve.gill_engine import (GillDecodeEngine,
                                              GillServeRequest)

FLAGS = [("model", str, "OPT preset (default facebook/opt-2.7b)"),
         ("slots", int, "decode slots (16)"),
         ("chunk", int, "decode steps a chunk (32)")]


@torch.no_grad()
def probe(model=S.MODEL, slots=16, chunk=32, max_seq=512,
          buckets=(64, 128, 256), wave=(16, 256), pos=300, n_chunk=5,
          n_wave=3, device="cuda", core=None, params=None):
    print(clock_note(device), flush=True)
    core, params = S.gill_model(model, device, core, params)
    eng = GillDecodeEngine(core, params, slots=slots, max_seq=max_seq,
                           chunk=chunk, prefill_buckets=buckets,
                           kv_dtype=S.act_dtype(device))
    e = eng.emb_dim
    eng.run([GillServeRequest(uid=j, embs=np.zeros((b - b // 4, e),
                                                   np.float32), num_words=4)
             for j, b in enumerate(buckets)])
    rows = []

    # (a) the GILL chunk, steady state
    S.steady_gill(eng, pos)
    for _ in range(2):
        eng._chunk(eng.max_seq, None)
    dt = wall_ms(lambda: eng._chunk(eng.max_seq, None), device, n_chunk)
    rows.append({"part": "gill_chunk", "steps": chunk, "ms": dt,
                 "tok_s_ceiling": slots * chunk / (dt / 1e3)})
    print(f"gill chunk ({chunk} steps): {dt:.1f} ms -> "
          f"{slots * chunk / (dt / 1e3):.0f} tok/s ceiling", flush=True)

    # (b) a prefill wave from host embeddings, and their copy alone
    r, p = wave
    embs = np.zeros((r, p, e), np.float32)
    dtype = eng.cache["k"].dtype

    def prefill():
        eng._prefill(torch.from_numpy(embs).to(eng.device, dtype),
                     np.ones((r,), np.int32), np.full((r,), slots, np.int32),
                     [None] * r, None)

    dt = wall_ms(prefill, device, n_wave)
    rows.append({"part": "gill_prefill_wave", "reqs": r, "rows": p,
                 "ms": dt})
    print(f"gill prefill wave ({r}x{p}): {dt:.1f} ms", flush=True)
    mb = embs.size * torch.finfo(dtype).bits / 8 / 1e6
    dt = wall_ms(lambda: torch.from_numpy(embs).to(eng.device, dtype),
                 device, n_wave)
    rows.append({"part": "embs_host_to_device", "mb": mb, "ms": dt})
    print(f"  embs host->device ({mb:.0f} MB): {dt:.1f} ms", flush=True)

    # (c) the plain-LM engine's chunk at the same shape
    cfg = core.opt_cfg
    del eng
    peng = DecodeEngine(params["lm"], cfg, slots=slots, max_seq=max_seq,
                        chunk=chunk, prefill_buckets=buckets,
                        kv_dtype=dtype)
    peng.run(S.warm_requests((buckets[0] - buckets[0] // 4,)))
    S.steady_lm(peng, pos)
    for _ in range(2):
        peng._chunk(peng.max_seq)
    dt = wall_ms(lambda: peng._chunk(peng.max_seq), device, n_chunk)
    rows.append({"part": "plain_chunk", "steps": chunk, "ms": dt,
                 "tok_s_ceiling": slots * chunk / (dt / 1e3)})
    print(f"plain chunk ({chunk} steps): {dt:.1f} ms -> "
          f"{slots * chunk / (dt / 1e3):.0f} tok/s ceiling", flush=True)
    return rows


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(probe, __doc__, argv, device, FLAGS, **kw)


if __name__ == "__main__":
    sys.exit(main())
