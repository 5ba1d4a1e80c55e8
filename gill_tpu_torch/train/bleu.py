"""Corpus BLEU-1..4 (replaces torchmetrics BLEUScore used at reference
gill/validate.py:21,239-246). Uniform weights, standard brevity penalty.
A copy of gill_tpu/train/bleu.py."""

from __future__ import annotations

import collections
import math
from typing import List, Sequence


def _ngrams(tokens: Sequence[str], n: int):
    return collections.Counter(
        tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu_score(candidates: List[str], references: List[str],
               max_n: int = 4) -> List[float]:
    """Returns [BLEU-1, ..., BLEU-max_n] over whitespace-tokenized corpus.

    references[i] is the single reference for candidates[i] (the val loop
    compares generated captions to GT captions 1:1)."""
    assert len(candidates) == len(references)
    clipped = [0] * (max_n + 1)
    totals = [0] * (max_n + 1)
    cand_len = 0
    ref_len = 0
    for cand, ref in zip(candidates, references):
        c_toks = cand.split()
        r_toks = ref.split()
        cand_len += len(c_toks)
        ref_len += len(r_toks)
        for n in range(1, max_n + 1):
            c_ng = _ngrams(c_toks, n)
            r_ng = _ngrams(r_toks, n)
            totals[n] += max(len(c_toks) - n + 1, 0)
            clipped[n] += sum(min(cnt, r_ng[g]) for g, cnt in c_ng.items())

    if cand_len == 0:
        return [0.0] * max_n
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
    out = []
    for k in range(1, max_n + 1):
        precisions = []
        for n in range(1, k + 1):
            if totals[n] == 0:
                precisions.append(0.0)
            else:
                precisions.append(clipped[n] / totals[n])
        if min(precisions) > 0:
            log_avg = sum(math.log(p) for p in precisions) / k
            out.append(bp * math.exp(log_avg))
        else:
            out.append(0.0)
    return out
