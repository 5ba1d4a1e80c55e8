"""Tensor-core orientation/dtype probes for the SD attention shapes.

Port of scripts/attn_mxu_probe.py. Times the hand-written kernel that
repeats one product REPS times from shared memory (ops/mm_probe.py, no
device-memory traffic in the loop), isolating the tensor cores' rate:
  A: QK bf16      (512,128)@(128,2048)
  B: QK int8      same, int8 -> int32
  C: PV bf16      (512,4096)@(4096,128)
  C8: PV int8     same, int8 -> int32
  D: PV^T bf16    (40,4096)@(4096,512)    <- small-M orientation
  E: PV^T bf16    (48,4096)@(4096,512)
  F: PV^T bf16    (128,4096)@(4096,512)
Each row: microseconds a product, T/s (TFLOP/s, TOP/s for int8), the share
of the card's data-sheet peak (WMMA cannot reach it, which needs wgmma),
and the same product through one library call (`torch.matmul` for bf16,
`torch._int_mm` for int8) beside it.

    python -m gill_tpu_torch.scripts.attn_mxu_probe [--out PATH]
"""

from __future__ import annotations

import sys

import torch

from gill_tpu_torch.ops.mm_probe import REPS, mm_probe
from gill_tpu_torch.scripts._timing import (PEAK_FLOPS, clock_note, delta_ms,
                                            probe_main)

CASES = [
    ("A QK bf16 (512,128)x(128,2048)", 512, 128, 2048, "bfloat16"),
    ("B QK int8", 512, 128, 2048, "int8"),
    ("C PV bf16 (512,4096)x(4096,128)", 512, 4096, 128, "bfloat16"),
    ("C8 PV int8", 512, 4096, 128, "int8"),
    ("D PVt bf16 (40,4096)x(4096,512)", 40, 4096, 512, "bfloat16"),
    ("E PVt bf16 (48,4096)x(4096,512)", 48, 4096, 512, "bfloat16"),
    ("F PVt bf16 (128,4096)x(4096,512)", 128, 4096, 512, "bfloat16"),
]


def operands(m, k, n, dtype, device, seed=0):
    """The script's data: normal * 3 cast to the operand dtype (int8 casts
    truncate toward zero)."""
    g = torch.Generator(device).manual_seed(seed)
    dt = getattr(torch, dtype)
    a = (torch.randn(m, k, device=device, generator=g) * 3).to(dt)
    b = (torch.randn(k, n, device=device, generator=g) * 3).to(dt)
    return a, b


def library_call(a, b):
    """The same product in one library call."""
    if a.dtype == torch.int8:
        return torch._int_mm(a, b) if a.is_cuda else a.int() @ b.int()
    return torch.matmul(a, b)


def probe(cases=CASES, device="cuda", n1=2, n2=12):
    """Times every case; prints the script's rows and returns them."""
    print(clock_note(device), flush=True)
    rows = []
    for name, m, k, n, dtype in cases:
        rec = {"case": name, "m": m, "k": k, "n": n, "dtype": dtype}
        try:
            a, b = operands(m, k, n, dtype, device)
            t = delta_ms(lambda: mm_probe(a, b), device, n1, n2) / 1e3
            tl = delta_ms(lambda: library_call(a, b), device, n1, n2) / 1e3
            fl = 2 * m * k * n * REPS
            peak = PEAK_FLOPS["int8" if dtype == "int8" else "bf16"]
            rec.update(us_per_mm=t * 1e6 / REPS, t_per_s=fl / t / 1e12,
                       peak_share=fl / t / peak,
                       library_us_per_mm=tl * 1e6,
                       library_t_per_s=fl / REPS / tl / 1e12)
            print(f"{name:<36} {rec['us_per_mm']:8.2f} us/mm  "
                  f"{rec['t_per_s']:7.1f} T/s  {100 * rec['peak_share']:5.1f}% "
                  f"of peak   library {rec['library_us_per_mm']:8.2f} us/mm  "
                  f"{rec['library_t_per_s']:7.1f} T/s", flush=True)
        except Exception as e:   # a case the card cannot run: say why
            rec["failed"] = f"{type(e).__name__}: {e}"
            print(f"{name:<36} FAILED {str(e)[:120]}", flush=True)
        rows.append(rec)
    return rows


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(probe, __doc__, argv, device, **kw)


if __name__ == "__main__":
    sys.exit(main())
