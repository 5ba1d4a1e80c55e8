"""A/B the valid-prefix decode-attention kernel vs the plain full-cache-read
decode path on the card, at serving shapes.

Port of scripts/profile_prefix_decode.py. Per config, device microseconds
a call (CUDA events, the delta between N_LO and N_HI calls) of
  plain  - ops/attention._decode_attention (reads the whole bucket)
  kernel - ops/decode_attn.prefix_decode_attention (K6, reads each row's
           valid prefix)
at three occupancy mixes: full (every row at bucket), mixed (uniform
[1, S], the continuous-batching steady state), halfpark (the same lengths
with every other row parked at 0). One JSON line each; the original's
`xla_us` / `pallas_us` are `plain_us` / `kernel_us` here. This is the
card's evidence for taking K6 on every eligible decode without gill_tpu's
TPU-measured minimum bucket. Nothing is written without --out (the
original overwrites PREFIX_DECODE_PROBE.json, a TPU record).

    python -m gill_tpu_torch.scripts.profile_prefix_decode [--out PATH]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from gill_tpu_torch.ops.attention import _decode_attention
from gill_tpu_torch.ops.decode_attn import prefix_decode_attention
from gill_tpu_torch.scripts._timing import clock_note, delta_ms, probe_main

CONFIGS = [
    # d % 128 == 0 only (the kernel's scope: the OPT-6.7B head shape)
    ("serve67_s16", 16, 512, 32, 128),   # 6.7b 16-slot pool
    ("serve67_s32", 32, 512, 32, 128),   # 6.7b 32-slot pool
    ("long67_b8", 8, 768, 32, 128),      # 6.7b 512+256 long context
    ("short67_b64", 64, 128, 32, 128),   # 6.7b b64 throughput config
]
N_LO, N_HI = 16, 80


def probe(configs=CONFIGS, device="cuda", n_lo=N_LO, n_hi=N_HI):
    print(clock_note(device), flush=True)
    rng = np.random.RandomState(0)
    g = torch.Generator(device).manual_seed(0)
    rows = []
    for name, b, s, h, d in configs:
        scale = 1.0 / np.sqrt(d)
        k, v, q, k1, v1 = (
            (torch.randn(b, n, h, d, device=device, generator=g) * 0.3)
            .to(torch.bfloat16) for n in (s, s, 1, 1, 1))
        # halfpark derives from the same sampled lengths as mixed (every
        # other row zeroed), so the parked-slot effect is isolated from
        # length-sampling variance
        mixed = rng.randint(1, s + 1, size=b)
        mixes = {"full": np.full((b,), s, np.int64), "mixed": mixed,
                 "halfpark": np.where(np.arange(b) % 2 == 0, mixed, 0)}
        for mix, lens_np in mixes.items():
            lens = torch.as_tensor(lens_np, dtype=torch.int32, device=device)
            off = lens - 1

            def plain():
                return _decode_attention(q, k, v, scale=scale, kv_offset=off,
                                         extra_kv=(k1, v1))

            def kernel():
                return prefix_decode_attention(q, k, v, lens, k1, v1,
                                               scale=scale)

            t_p = delta_ms(plain, device, n_lo, n_hi) / 1e3
            t_k = delta_ms(kernel, device, n_lo, n_hi) / 1e3
            rec = {"config": name, "mix": mix,
                   "plain_us": round(t_p * 1e6, 1),
                   "kernel_us": round(t_k * 1e6, 1),
                   "speedup": round(t_p / t_k, 3)}
            rows.append(rec)
            print(json.dumps(rec), flush=True)
    return rows


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(probe, __doc__, argv, device, **kw)


if __name__ == "__main__":
    sys.exit(main())
