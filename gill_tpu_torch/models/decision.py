"""Decision classifier: routes each [IMG] request to generation vs
retrieval (counterpart of gill_tpu/models/decision.py; reference
nn.Sequential(Dropout(0.5), Linear(4096, 2)) with a softmax argmax over
idx2dec, gill/models.py:545,553-561,695-701). Inference only."""

from __future__ import annotations

from typing import List, Tuple

import torch

IDX2DEC = {0: "gen", 1: "ret", 2: "same"}


def apply(params, x):
    """x (N, in_dim) -> logits (N, num_classes), in fp32."""
    return x.float() @ params["w"].float() + params["b"].float()


def decide(params, hidden) -> Tuple[str, List[float]]:
    """[IMG0] hidden (1, in_dim) -> ('gen'|'ret', [probs])."""
    logits = apply(params, hidden)
    probs = torch.softmax(logits, dim=-1)
    label = IDX2DEC[int(logits.argmax())]
    return label, probs.cpu().numpy().tolist()
