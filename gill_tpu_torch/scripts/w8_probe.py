"""Streaming-bandwidth probe for the W8A16 decode matmul (ops/w8_matmul.py,
K4) at OPT-6.7B decode shapes.

Port of scripts/w8_probe.py. A decode step is bound by its weight stream,
so the kernel's GB/s is what serving can reach. At M = 8 over the three
decode shapes: the bf16 `torch.matmul` with the dequantized weight (a
reference that reads 2x the bytes; the port never calls it), then the
kernel at every (block_n, block_k) that `w8_plan` accepts. Each time is
L2-cold: the calls cycle through copies of the weight, >= 2x the L2 in all
(`_timing.cuda_ms_cycled`), as a decode step finds each layer's weights
out of the L2. ms a call and GB/s (weight bytes over that time).

    python -m gill_tpu_torch.scripts.w8_probe [--out PATH]
"""

from __future__ import annotations

import sys

import torch

from gill_tpu_torch.ops.w8_matmul import (BLOCK_KS, BLOCK_NS, w8_matmul,
                                          w8_plan)
from gill_tpu_torch.scripts._timing import (clock_note, cold_copies,
                                            cycled_ms, probe_main)

M = 8
SHAPES = [(4096, 4096), (4096, 16384), (16384, 4096)]


def probe(shapes=SHAPES, m=M, device="cuda", reps=24):
    """Times the reference and every accepted kernel plan at each (K, N);
    prints the script's rows and returns them."""
    print(clock_note(device), flush=True)
    print(f"{'shape':<16}{'config':<28}{'ms':>8}{'GB/s':>8}", flush=True)
    cuda = torch.device(device).type == "cuda"
    g = torch.Generator(device).manual_seed(0)
    rows = []
    for k, n in shapes:
        gb = k * n / 1e9
        x = torch.randn(m, k, device=device, generator=g).bfloat16()
        ws = torch.full((n,), 1e-3, device=device)
        w8s = [torch.randint(-127, 128, (k, n), device=device, generator=g,
                             dtype=torch.int8)
               for _ in range(cold_copies(k * n) if cuda else 1)]
        cases = [("bf16 matmul (2x bytes)", None, 2 * gb)]
        cases += [(f"K4 bn={bn} bk={bk}", (bn, bk), gb)
                  for bn in BLOCK_NS for bk in BLOCK_KS
                  if _accepts(m, k, n, bn, bk)]
        for name, blocks, nbytes in cases:
            rec = {"shape": [k, n], "config": name, "m": m}
            try:
                if blocks is None:
                    wbs = [(w.bfloat16() * ws.bfloat16()) for w in
                           (w8s * 2)[:cold_copies(2 * k * n) if cuda else 1]]
                    fns = [lambda w=w: torch.matmul(x, w) for w in wbs]
                else:
                    rec["block_n"], rec["block_k"] = blocks
                    fns = [lambda w=w: w8_matmul(x, w, ws, block_n=blocks[0],
                                                 block_k=blocks[1])
                           for w in w8s]
                t = cycled_ms(fns, device, reps)
                rec.update(ms=t, gb_s=nbytes / t * 1e3)
                print(f"{k}x{n:<10}{name:<28}{t:>8.4f}{rec['gb_s']:>8.0f}",
                      flush=True)
            except Exception as e:   # a plan the card cannot run: say why
                rec["failed"] = f"{type(e).__name__}: {e}"
                print(f"{k}x{n:<10}{name:<28} FAILED {str(e)[:120]}",
                      flush=True)
            rows.append(rec)
            fns = wbs = None
        print(flush=True)
    return rows


def _accepts(m, k, n, bn, bk) -> bool:
    try:
        w8_plan(m, k, n, torch.bfloat16, block_n=bn, block_k=bk)
        return True
    except ValueError:
        return False


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(probe, __doc__, argv, device, **kw)


if __name__ == "__main__":
    sys.exit(main())
