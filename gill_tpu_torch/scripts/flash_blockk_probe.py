"""K2 (csrc/flash_mma.cu) at every tile on the SD 64x64 self-attention
shape (B 8, the CFG batch, H 8, S 4096, d 40), on the card.

Port of scripts/flash_blockk_probe.py. The original sweeps the TPU
kernel's (block_q, block_k) from 512 to 4096 over a head dim padded to
128. The port's K2 reads d 40 as it is and takes its own tiles:
`flash_attention(block_q=, block_k=)` at every pair `mma_tile` accepts
(MMA_TILES each), then the tile it picks by shape ("auto"). Each row is
device ms (CUDA events, the delta between n1 and n2 calls), the useful
TFLOP/s (4 B H S^2 d), its max error against the plain version
(`flash_attention_ref`) and its time against
`scaled_dot_product_attention` on the same inputs; two more rows time
SDPA and the plain version. The original writes FLASH_BLOCKK_PROBE.json;
nothing is written here without --out.

    python -m gill_tpu_torch.scripts.flash_blockk_probe [--device cuda]
        [--out PATH]
"""

from __future__ import annotations

import json
import sys

import torch
import torch.nn.functional as F

from gill_tpu_torch.ops.attention import (MMA_TILES, flash_attention,
                                          flash_attention_ref, mma_tile)
from gill_tpu_torch.scripts._timing import clock_note, delta_ms, probe_main

SHAPE = (8, 4096, 8, 40)     # B, S, H, D


def probe(shape=SHAPE, device="cuda", n1=2, n2=12, plain_n=(1, 3)):
    print(clock_note(device), flush=True)
    b, s, h, d = shape
    g = torch.Generator(device).manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, device=device, generator=g) * 0.3
               for _ in range(3))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    scale = d ** -0.5
    flops = 4.0 * b * h * s * s * d
    ref = flash_attention_ref(q, k, v, scale=scale)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, scale=scale)

    sdpa_ms = delta_ms(sdpa, device, n1, n2)
    rows = []

    def row(label, fn, ms, **extra):
        out = fn()
        rec = {"block_q": label[0], "block_k": label[1], "ms": ms,
               "tflops": flops / (ms * 1e-3) / 1e12,
               "max_err_vs_plain": float((out.float() - ref.float())
                                         .abs().max()),
               "vs_sdpa": ms / sdpa_ms, **extra}
        rows.append(rec)
        print(json.dumps(rec), flush=True)

    for bq in MMA_TILES:
        for bk in MMA_TILES:
            def fn(bq=bq, bk=bk):
                return flash_attention(q, k, v, scale=scale, block_q=bq,
                                       block_k=bk)
            row((bq, bk), fn, delta_ms(fn, device, n1, n2))

    def auto():
        return flash_attention(q, k, v, scale=scale)
    tile = mma_tile(s)
    row((f"auto({tile[0]})", f"auto({tile[1]})"), auto,
        delta_ms(auto, device, n1, n2))
    row(("sdpa", "sdpa"), lambda: sdpa().transpose(1, 2), sdpa_ms)

    def plain():
        return flash_attention_ref(q, k, v, scale=scale)
    row(("plain", "plain"), plain, delta_ms(plain, device, *plain_n))
    return rows


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(probe, __doc__, argv, device, **kw)


if __name__ == "__main__":
    sys.exit(main())
