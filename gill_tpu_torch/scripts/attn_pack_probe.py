"""Times the head layouts of the SD UNet's 64x64 self-attention (B 8, the
CFG batch, S 4096, H 8 heads of d 40) on the card.

Port of scripts/attn_pack_probe.py, which measures the TPU's padding of
d 40 to its 128-lane tiles. On this card K2 (csrc/flash_mma.cu) reads
d 40 as it is: its QK product takes the 40 columns as two k16 steps and
one k8 step of `mma.sync` (m16n8k16, then m16n8k8), so nothing is padded
to 48 or 128, and P V writes five n8 column tiles. The rows, each device
ms (CUDA events, the delta between N_LO and N_HI calls) with its useful
TFLOP/s (4 B H S^2 d) and its time against the first row:

  k2_d40           K2 on (B, S, H, 40), the UNet's path;
  padded_d128      the flash kernel on q, k, v zero-padded to d 128 (the
                   original's layout; at d > 80 that is csrc/flash_mma.cu's
                   K1 path), its padded TFLOP/s beside;
  sdpa_d40         `scaled_dot_product_attention` on (B, H, S, 40);
  plain_d40        the plain version (`flash_attention_ref`).

The original writes ATTN_PACK_PROBE.json; nothing is written here without
--out.

    python -m gill_tpu_torch.scripts.attn_pack_probe [--device cuda]
        [--out PATH]
"""

from __future__ import annotations

import json
import sys

import torch
import torch.nn.functional as F

from gill_tpu_torch.ops.attention import flash_attention, flash_attention_ref
from gill_tpu_torch.scripts._timing import clock_note, delta_ms, probe_main

B, S, H, D, DP = 8, 4096, 8, 40, 128
N_LO, N_HI = 2, 10


def probe(shape=(B, S, H, D), padded=DP, device="cuda", n_lo=N_LO,
          n_hi=N_HI, plain_n=(1, 3)):
    print(clock_note(device), flush=True)
    b, s, h, d = shape
    g = torch.Generator(device).manual_seed(0)
    q, k, v = ((torch.randn(b, s, h, d, device=device, generator=g) * 0.1)
               .to(torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    qp, kp, vp = (F.pad(x, (0, padded - d)) for x in (q, k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    useful = 4.0 * b * h * s * s * d
    runs = [
        ("k2_d40", lambda: flash_attention(q, k, v, scale=scale), (n_lo,
                                                                     n_hi)),
        ("padded_d128", lambda: flash_attention(qp, kp, vp, scale=scale)
         [..., :d], (n_lo, n_hi)),
        ("sdpa_d40", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=scale).transpose(1, 2), (n_lo, n_hi)),
        ("plain_d40", lambda: flash_attention_ref(q, k, v, scale=scale),
         plain_n)]
    ref = flash_attention_ref(q, k, v, scale=scale).float()
    rows = []
    for name, fn, (n1, n2) in runs:
        ms = delta_ms(fn, device, n1, n2)
        rec = {"layout": name, "ms": ms,
               "useful_tflops": useful / (ms * 1e-3) / 1e12,
               "max_err_vs_plain": float((fn().float() - ref).abs().max()),
               "vs_k2": ms / rows[0]["ms"] if rows else 1.0}
        if name == "padded_d128":
            rec["padded_tflops"] = useful * padded / d / (ms * 1e-3) / 1e12
        rows.append(rec)
        print(json.dumps(rec), flush=True)
    return rows


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(probe, __doc__, argv, device, **kw)


if __name__ == "__main__":
    sys.exit(main())
