"""Loss functions and accuracy metrics (gill_tpu/train/losses.py;
reference gill/losses.py and gill/utils.py:128-150).

The contrastive loss takes the whole batch's logit matrix: the port trains
in one process, so the reference's all_gather with the local slice
overwritten (main.py:522-535) has nothing to gather.
"""

from __future__ import annotations

import torch


def l2_loss(u, v):
    """Per-token Euclidean distance summed over the feature dim.

    u, v: (N, T, D) (or (N, D)). Returns (N, T) (or (N,)), as the
    reference's losses.py:19-28 (an L2 norm, not its square)."""
    if u.shape != v.shape:
        raise ValueError(f"l2_loss shapes {tuple(u.shape)} {tuple(v.shape)}")
    return torch.sqrt(torch.clamp(((u - v) ** 2).sum(dim=-1), min=1e-12))


def contrastive_loss(logits):
    """InfoNCE: the CE of each row against the diagonal (losses.py:31)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.diagonal(logp).mean()


def contrastive_acc(logits, topk=(1,)):
    """Top-k accuracy of the diagonal target, in percent (a stable sort,
    as jnp.argsort, so ties rank as in gill_tpu)."""
    n = logits.shape[0]
    target = torch.arange(n, device=logits.device)
    order = torch.argsort(-logits, dim=-1, stable=True)
    return [100.0 * (order[:, :k] == target[:, None]).any(dim=-1).float()
            .mean() for k in topk]


def token_accuracy(logits, labels, ignore_index: int = -100, topk=(1, 5)):
    """Top-k next-token accuracy over the unmasked positions, in percent.

    logits: (B, T, V), already aligned with labels (the caller passes
    logits[:, :-1] against labels[:, 1:], reference main.py:504). The rank
    is the count of logits above the target's (one compare + sum over V,
    gill_tpu's replacement of top_k); an exact tie ranks the target
    optimistically."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    target = torch.gather(logits, -1, safe[..., None])          # (B, T, 1)
    rank = (logits > target).sum(dim=-1)                         # 0 = argmax
    denom = valid.sum().clamp_min(1)
    return [100.0 * ((rank < k) & valid).sum() / denom for k in topk]
