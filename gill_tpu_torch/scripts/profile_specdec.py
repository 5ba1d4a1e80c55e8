"""Measures the speculative-decoding round mechanics on the card (port of
scripts/profile_specdec.py).

With random or zero weights the draft's acceptance says nothing about a
real pair of models, so what is measured is the machinery: the host-clock
ms of one draft-k + verify round (serve/speculative.py `_round`: k draft
steps, one (k + 1)-token verify of the target, one host sync) beside one
plain one-token decode step of the target at batch 1, and from them the
tokens/s at each acceptance rate a and the breakeven a:

    E[tokens/round] = (1 - a^k) / (1 - a)   (commit cap k - 1 + correction)
    spec_tps(a)     = E[tokens/round] / round time
    breakeven a     : spec_tps(a) == 1 / plain step time

Each time is the delta between two numbers of rounds (steps), as the
original takes between two scan lengths. The target is OPT-6.7B with W8
weights (`quantize_params_w8` of `init_dummy`'s zeros), the draft OPT-125m
in bf16, k = 8, a 64-token prompt; the W8 matmul's and the decode
attention's launches a round are counted. The original's `GILL_SPEC_*`
environment variables are the probe's arguments here. Nothing is written
without --out.

    python -m gill_tpu_torch.scripts.profile_specdec [--out PATH]
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from gill_tpu_torch.config import OPTConfig
from gill_tpu_torch.models import opt as opt_mod
from gill_tpu_torch.scripts._timing import clock_note, probe_main, wall_ms
from gill_tpu_torch.serve.speculative import SpeculativeDecoder

TARGET = "facebook/opt-6.7b"
DRAFT = "facebook/opt-125m"
K = 8
PLEN = 64
ROUNDS = (4, 12)
STEPS = (32, 96)
ACCEPTANCE = (0.0, 0.3, 0.5, 0.6, 0.7, 0.8, 0.9)


def _launch_counters():
    from gill_tpu_torch.ops import decode_attn, w8_matmul

    return {"w8_matmul": w8_matmul.w8_matmul,
            "prefix_decode_attention": decode_attn.prefix_decode_attention}


def tokens_per_round(a: float, k: int) -> float:
    return (1 - a ** k) / (1 - a) if a < 1 else float(k)


def breakeven(round_ms: float, step_ms: float, k: int) -> float:
    """The acceptance rate at which a round's tokens/s equals the plain
    step's (bisection; 1.0 where no rate below 1 reaches it)."""
    if tokens_per_round(1.0, k) * step_ms <= round_ms:
        return 1.0
    lo, hi = 0.0, 1.0
    for _ in range(40):
        mid = (lo + hi) / 2
        if tokens_per_round(mid, k) / round_ms >= 1 / step_ms:
            hi = mid
        else:
            lo = mid
    return hi


@torch.no_grad()
def probe(target=TARGET, draft=DRAFT, k=K, plen=PLEN, rounds=ROUNDS,
          steps=STEPS, device="cuda"):
    print(clock_note(device), flush=True)
    tcfg = OPTConfig.from_name(target) if isinstance(target, str) else target
    dcfg = dataclasses.replace(
        OPTConfig.from_name(draft) if isinstance(draft, str) else draft,
        vocab_size=tcfg.vocab_size)
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32
    tparams = opt_mod.quantize_params_w8(
        opt_mod.init_dummy(tcfg, dtype, device=device))
    dparams = opt_mod.init_dummy(dcfg, dtype, device=device)
    dec = SpeculativeDecoder(tparams, tcfg, dparams, dcfg, k=k, max_seq=512,
                             prefill_buckets=(64,), kv_dtype=dtype)
    prompt = [5] * plen
    counters = _launch_counters()

    def timed_rounds(n):
        tc, dc, first = dec._prefill(prompt)
        last = torch.tensor([first], device=device)

        def run():
            pos, cur = plen, last
            for _ in range(n):
                pos, cur, _ = dec._round(tc, dc, pos, cur)
        run()                                  # warm-up on the same caches
        before = {name: fn.launches for name, fn in counters.items()}
        ms = wall_ms(run, device)
        return ms, {name: fn.launches - before[name]
                    for name, fn in counters.items()}

    (t1, _), (t2, launches) = timed_rounds(rounds[0]), timed_rounds(rounds[1])
    round_ms = max((t2 - t1) / (rounds[1] - rounds[0]), 1e-6)
    per_round = {name: n / rounds[1] for name, n in launches.items()}

    head = tparams["embed_tokens"]["weight"].float()

    def timed_steps(n):
        cache = opt_mod.init_cache(tcfg, 1, 512, device=device, dtype=dtype)

        def run():
            tok = torch.tensor([[7]], device=device)
            for i in range(n):
                out = opt_mod.forward(tparams, tcfg,
                                      opt_mod.embed_tokens(tparams, tok),
                                      cache=cache, cache_pos=plen + i,
                                      lm_head=head)
                tok = out["logits"][0, -1].argmax().view(1, 1)
        run()
        return wall_ms(run, device)

    step_ms = max((timed_steps(steps[1]) - timed_steps(steps[0]))
                  / (steps[1] - steps[0]), 1e-6)
    name_t, name_d = (c if isinstance(c, str) else "custom"
                      for c in (target, draft))
    print(f"spec round (K={k}, {name_t.split('/')[-1]} W8 + "
          f"{name_d.split('/')[-1]} draft): {round_ms:.2f} ms "
          f"(host clock; launches a round: {per_round})", flush=True)
    print(f"plain decode step (batch 1): {step_ms:.2f} ms "
          f"({1000 / step_ms:.0f} tok/s)", flush=True)
    rows = [{"round_ms": round_ms, "step_ms": step_ms, "k": k,
             "target": name_t, "draft": name_d,
             "launches_per_round": per_round}]
    print("\nacceptance -> tokens/s (spec) vs plain:", flush=True)
    for a in ACCEPTANCE:
        e = tokens_per_round(a, k)
        tps = e / (round_ms / 1e3)
        print(f"  a={a:.1f}: E[tok/round]={e:.2f} -> {tps:6.1f} tok/s "
              f"({tps * step_ms / 1000:.2f}x plain)", flush=True)
        rows.append({"a": a, "tokens_per_round": e, "tokens_per_s": tps,
                     "x_plain": tps * step_ms / 1000})
    a_even = breakeven(round_ms, step_ms, k)
    print(f"breakeven acceptance: a = {a_even:.3f}", flush=True)
    rows[0]["breakeven_acceptance"] = a_even
    return rows


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(probe, __doc__, argv, device, **kw)


if __name__ == "__main__":
    sys.exit(main())
