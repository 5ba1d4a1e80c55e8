"""CC3M retrieval index: load, score, top-k (counterpart of
gill_tpu/retrieval.py; reference gill/models.py:671-693, 824-839).

The (N, D) embedding matrix lives on the index's device, rows normalized
and premultiplied by the logit scale; a query is one matmul plus a top-k,
with each previously seen row downweighted by -1000 per occurrence. The
multi-device shard merge of gill_tpu is not ported.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def load_embeddings(model_dir: str, pattern: str = "cc3m*.npy"
                    ) -> Tuple[Optional[List[str]], Optional[np.ndarray]]:
    """Reads the pickled {'paths', 'embeddings'} blobs (the reference's
    cc3m*.npy format). Returns (paths, (N, D) float32) or (None, None)."""
    paths: List[str] = []
    embs: List[np.ndarray] = []
    for p in sorted(glob.glob(os.path.join(model_dir, pattern))):
        with open(p, "rb") as f:
            blob = pickle.load(f)
        paths.extend(blob["paths"])
        embs.extend(blob["embeddings"])
    if not paths:
        return None, None
    mat = np.stack(embs, axis=0).astype(np.float32)
    if len(paths) != mat.shape[0]:
        raise ValueError(f"{len(paths)} paths for {mat.shape[0]} embeddings")
    return paths, mat


class RetrievalIndex:
    """Device-resident normalized, logit_scale-premultiplied index."""

    def __init__(self, paths: Sequence[str], emb_matrix, logit_scale: float,
                 device=None):
        self.paths = list(paths)
        mat = torch.as_tensor(emb_matrix, device=device).float()
        mat = mat / torch.linalg.vector_norm(mat, dim=1, keepdim=True)
        self.matrix = mat * float(logit_scale)
        self.n = self.matrix.shape[0]
        if len(self.paths) != self.n:
            raise ValueError(f"{len(self.paths)} paths for {self.n} rows")

    def topk_batch(self, queries, k: int = 3,
                   seen_idx: Optional[Sequence[Sequence[int]]] = None):
        """(B, D) queries -> (scores (B, k), indices (B, k)) as numpy;
        `seen_idx[b]` lists rows to downweight for query b."""
        q = torch.as_tensor(queries, device=self.matrix.device).float()
        if q.ndim != 2:
            raise ValueError(f"queries must be (B, D), got {tuple(q.shape)}")
        scores = q @ self.matrix.t()
        for i, seen in enumerate(seen_idx or ()):
            if len(seen):
                ids = torch.as_tensor(list(seen), device=scores.device)
                scores[i].index_add_(0, ids, torch.full(
                    (len(seen),), -1000.0, device=scores.device))
        vals, idx = torch.topk(scores, k, dim=-1)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def topk(self, query, k: int = 3, seen_idx: Sequence[int] = ()):
        """(D,) query -> (scores (k,), indices (k,))."""
        q = torch.as_tensor(query).reshape(1, -1)
        scores, idx = self.topk_batch(q, k, [seen_idx])
        return scores[0], idx[0]

    def scores_for(self, query, idx: Sequence[int]) -> np.ndarray:
        rows = self.matrix[torch.as_tensor(list(idx),
                                           device=self.matrix.device)]
        q = torch.as_tensor(query, device=self.matrix.device).float()
        return (rows @ q).cpu().numpy()
