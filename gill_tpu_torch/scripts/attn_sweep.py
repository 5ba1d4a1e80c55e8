"""Sweep flash-attention kernel variants on the SD 64x64 self-attention
shape (B=8 CFG batch, H=8, S=4096, d=40) on the card.

Port of scripts/attn_sweep.py: the same ten variants, each with its device
ms and its max error against the first row. Variant A ("current") is the
port's flash kernel (ops.attention.flash_attention, K2), as the original's
is gill_tpu's; the others are the S2/S3 kernel of ops/flash_variants.py,
and each row names the Hopper tile (query rows x keys a step) it ran for
the TPU block it stands for.

    python -m gill_tpu_torch.scripts.attn_sweep [--out PATH]
"""

from __future__ import annotations

import functools
import sys

import torch

from gill_tpu_torch.ops.attention import flash_attention, mma_tile
from gill_tpu_torch.ops.flash_variants import (flash_nomax, flash_variant,
                                               hopper_tile)
from gill_tpu_torch.scripts._timing import clock_note, delta_ms, probe_main

SHAPE = (8, 4096, 8, 40)     # B, S, H, D

# (name, block_q, block_k (None: S), probabilities' dtype, kt, no-max): the
# original's variants after the current kernel (its :200-210)
VARIANTS = [
    *[(f"single-pass bq={bq}", bq, None, "float32", False, False)
      for bq in (256, 512, 1024)],
    ("bq=512 online bk=1024", 512, 1024, "float32", False, False),
    ("bq=256 bf16-probs", 256, None, "bfloat16", False, False),
    ("bq=512 bf16-probs", 512, None, "bfloat16", False, False),
    ("bq=512 k-transposed", 512, None, "float32", True, False),
    ("bq=512 nomax", 512, None, "float32", False, True),
    ("bq=1024 nomax", 1024, None, "float32", False, True),
]


def build(spec, s: int):
    """(fn, block_q, block_k) of a VARIANTS entry at key length s; blocks
    larger than the tests' small shapes are cut (block_q to s, an online
    block_k to s / 2, so it stays online)."""
    _, bq, bk, pd, kt, nomax = spec
    bq, bk = min(bq, s), s if bk is None else min(bk, s // 2)
    if nomax:
        return (functools.partial(flash_nomax, block_q=bq, block_k=bk),
                bq, bk)
    return (functools.partial(flash_variant, block_q=bq, block_k=bk,
                              prob_dtype=getattr(torch, pd), kt=kt), bq, bk)


def inputs(shape=SHAPE, device="cuda", seed=0):
    b, s, h, d = shape
    g = torch.Generator(device).manual_seed(seed)
    return tuple(torch.randn(b, s, h, d, device=device, generator=g)
                 .to(torch.bfloat16) for _ in range(3))


def sweep(shape=SHAPE, device="cuda", n1=2, n2=12):
    """Times the current kernel and every variant; prints the script's
    rows and returns them."""
    print(clock_note(device), flush=True)
    q, k, v = inputs(shape, device)
    s = shape[1]
    tile = mma_tile(s)
    runs = [("current(auto 256xS)", "K2 " + "x".join(map(str, tile)),
             lambda q, k, v: flash_attention(q, k, v, causal=False))]
    for spec in VARIANTS:
        fn, bq, _ = build(spec, s)
        runs.append((spec[0], "x".join(map(str, hopper_tile(bq))), fn))
    ref, rows = None, []
    for name, tile, fn in runs:
        rec = {"variant": name, "hopper_tile": tile}
        try:
            t = delta_ms(lambda: fn(q, k, v), device, n1, n2)
            out = fn(q, k, v)
            if ref is None:
                ref, err = out, 0.0
            else:
                err = float((out.float() - ref.float()).abs().max())
            rec.update(ms=t, maxerr=err,
                       ref_max=float(ref.float().abs().max()))
            print(f"{name:<28}{t:>8.3f} ms   maxerr={err:.2e}   tile {tile}",
                  flush=True)
        except Exception as e:   # a variant the card cannot run: say why
            rec["failed"] = f"{type(e).__name__}: {e}"
            print(f"{name:<28}FAILED: {rec['failed']}", flush=True)
        rows.append(rec)
    return rows


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(sweep, __doc__, argv, device, **kw)


if __name__ == "__main__":
    sys.exit(main())
