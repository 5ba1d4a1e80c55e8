"""Sampling for the decode loop (counterpart of gill_tpu/ops/sampling.py).

Greedy decoding is `argmax` (the first maximal index wins, as in JAX).
Temperature + nucleus sampling draws from an explicit `torch.Generator`;
its random stream differs from JAX's threefry, so sampled tokens agree
with gill_tpu in distribution only.
"""

from __future__ import annotations

from typing import Optional

import torch


def top_p_filter(logits, top_p: float):
    """Nucleus filtering: keep the smallest prefix of the sorted
    distribution whose cumulative probability exceeds top_p, the first
    token always kept (keep j iff cum[j-1] <= top_p); others -> -inf."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) <= top_p
    kth = (keep.sum(dim=-1) - 1).clamp_min(0)
    thresh = sorted_logits.gather(-1, kth[..., None])
    return torch.where(logits < thresh, torch.full_like(logits, -torch.inf),
                       logits)


def sample_per_row(logits, temperature, top_p, uniforms):
    """Per-row sampling for the serving engines (gill_tpu
    `sample_per_row`): temperature (B,) and top_p (B,) are per-request
    data; rows with temperature 0 decode greedily, the others follow the
    reference order (scale by temperature, nucleus-filter, draw). The draw
    is the inverse CDF at one uniform a row, `uniforms` (B,) in [0, 1),
    which the caller derives from the request's seed and position; the
    token taken is the first whose cumulative probability reaches
    (1 - u) of the total, so a filtered (zero) entry is never drawn."""
    lf = logits.float()
    scaled = lf / temperature.float().clamp_min(1e-6)[:, None]
    filtered = top_p_filter(scaled, top_p.float()[:, None])
    cdf = torch.cumsum(torch.softmax(filtered, dim=-1), dim=-1)
    target = (1.0 - uniforms.float())[:, None] * cdf[:, -1:]
    drawn = (cdf < target).sum(dim=-1).clamp_max(lf.shape[-1] - 1)
    return torch.where(temperature > 0, drawn, lf.argmax(dim=-1))


def uniform_for(seed: int, counter: int) -> float:
    """The uniform draw of a request stream at one position: a CPU
    torch.Generator seeded from (seed, counter), so a request's draws do not
    depend on which slot or chunk serves it."""
    g = torch.Generator().manual_seed(int(seed) * (1 << 20) + int(counter))
    return float(torch.rand((), generator=g))


def sample(logits, temperature: float, top_p: float,
           generator: Optional[torch.Generator] = None):
    """(B, V) logits -> (B,) token ids. Greedy when temperature == 0."""
    if temperature == 0.0:
        if top_p < 1.0:
            raise ValueError("top_p cannot be set if temperature is 0")
        return logits.argmax(dim=-1)
    logits = logits.float() / temperature
    if top_p < 1.0:
        logits = top_p_filter(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
