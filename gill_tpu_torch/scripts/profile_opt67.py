"""A trace of the OPT-6.7B W8A16 decode on the card, its device time grouped
by kernel family, so that the gap between measured tokens/s and the weight
stream's bound can be attributed.

Port of scripts/profile_opt67.py (batch 8, prompt 32, 16 decode steps) on
`init_dummy`'s zero OPT-6.7B with its decoder linears in W8, decoded as
profile_decode decodes (per-row positions, as the serving engines). One
warm decode, then one under `utils.profiling.trace`; every CUDA event of
the trace is put in the first family whose pattern its name matches:

  K4 w8_matmul, K6 prefix_decode_attention, K1 flash_attention (the
  hand-written kernels), cuBLAS GEMMs, norms and reductions (the composed
  LayerNorms' and the argmax's reduce kernels), elementwise, copies,
  collectives, other.

It prints the total device time (and ms a token), each family's ms and
event count, and the top kernels by device time. The trace is written to
`--trace-dir` when given, else to a temporary directory that is removed;
nothing else is written without --out.

    python -m gill_tpu_torch.scripts.profile_opt67 [--model NAME]
        [--batch 8] [--prompt 32] [--gen 16] [--trace-dir DIR]
        [--device cuda] [--out PATH]
"""

from __future__ import annotations

import re
import sys
import tempfile
from collections import defaultdict

import torch

from gill_tpu_torch.scripts import _serving as S
from gill_tpu_torch.scripts._timing import clock_note, probe_main
from gill_tpu_torch.scripts.profile_decode import decoder
from gill_tpu_torch.utils import profiling

MODEL = "facebook/opt-6.7b"
FAMS = [
    ("K4 w8_matmul", r"w8_mma|w8_fma|w8_matmul"),
    ("K6 prefix_decode_attention", r"prefix_decode"),
    ("K1 flash_attention", r"flash_f32|flash_mma|qk_amax|qk_quantize"),
    ("cuBLAS GEMMs", r"gemm|gemv|xmma|cutlass|cublas"),
    ("norms and reductions", r"norm|reduce_kernel|[Rr]educe"),
    ("elementwise", r"elementwise|[Ii]ndex|where|fill|CatArray|cat_"),
    ("copies", r"Memcpy|Memset|[Cc]opy"),
    ("collectives", r"nccl|[Aa]ll[Rr]educe|[Bb]roadcast|gloo"),
]
FLAGS = [("model", str, "OPT preset (default facebook/opt-6.7b)"),
         ("batch", int, "decode rows (8)"),
         ("prompt", int, "prompt embedding rows (32)"),
         ("gen", int, "decode steps (16)"),
         ("trace_dir", str, "keep the Chrome trace here")]


def classify(name: str) -> str:
    for fam, pat in FAMS:
        if re.search(pat, name):
            return fam
    return "other"


def device_events(prof):
    """(name, device us) of every CUDA event of a profiler."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


@torch.no_grad()
def probe(model=MODEL, batch=8, prompt=32, gen=16, trace_dir=None,
          device="cuda", params=None):
    print(clock_note(device), flush=True)
    params, cfg = S.w8_lm(model, device, params)
    g = torch.Generator(device).manual_seed(1)
    x = (torch.randn(batch, prompt, cfg.word_embed_proj_dim, device=device,
                     generator=g) * 0.02).to(S.act_dtype(device))
    decode = decoder(params, cfg, x, gen)
    decode()
    cuda = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(trace_dir or tmp, cuda=cuda) as prof:
            decode()
        events = device_events(prof) if cuda else []
    if not cuda:
        print("device time: not measured (no CUDA device)", flush=True)
        return [{"family": "total", "device_ms": None, "events": 0}]
    fam_us, fam_n, op_us = defaultdict(float), defaultdict(int), \
        defaultdict(float)
    for name, us in events:
        fam = classify(name)
        fam_us[fam] += us
        fam_n[fam] += 1
        op_us[name[:80]] += us
    total = sum(fam_us.values())
    rows = [{"family": "total", "device_ms": total / 1e3,
             "ms_per_token": total / 1e3 / gen, "events": len(events)}]
    print(f"total device time: {total / 1e3:.2f} ms "
          f"({total / 1e3 / gen:.3f} ms/token over {gen} tokens + prefill)",
          flush=True)
    print("\nby kernel family:", flush=True)
    for fam, us in sorted(fam_us.items(), key=lambda kv: -kv[1]):
        rows.append({"family": fam, "device_ms": us / 1e3,
                     "events": fam_n[fam]})
        print(f"  {fam:<28}{us / 1e3:>9.2f} ms  n={fam_n[fam]}", flush=True)
    print("\ntop ops:", flush=True)
    for op, us in sorted(op_us.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {op:<80}{us / 1e3:>9.2f} ms", flush=True)
    return rows


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(probe, __doc__, argv, device, FLAGS, **kw)


if __name__ == "__main__":
    sys.exit(main())
