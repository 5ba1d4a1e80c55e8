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
