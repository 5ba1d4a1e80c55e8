"""CC3M retrieval index: load, score, top-k (counterpart of
gill_tpu/retrieval.py; reference gill/models.py:671-693, 824-839).

The (N, D) embedding matrix lives on the index's device, rows normalized
and premultiplied by the logit scale; a query is one matmul plus a top-k,
with each previously seen row downweighted by -1000 per occurrence.

With a mesh (`mesh=`, gill_tpu's sharded index) the rows are padded and
split over "data": each data rank keeps its block, pad rows score -inf,
the -1000 for seen ids applies only inside the rank's row range, each
rank takes its local top-k, and the (B, dp k) candidates, all-gathered
over "data", are merged by a top-k, so the collective moves O(dp k)
values, not the (B, N) scores. Rows are normalized and scored in
`score_window` blocks on global boundaries, so the sharded top-k equals
the one-process one bit for bit. Every data rank calls `topk_batch` with
the same queries (the SPMD contract).
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gill_tpu_torch.parallel.collectives import data_group


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


def score_window(n: int) -> int:
    """Rows a scoring product: the power of two that covers n, at most
    65,536. Every product of an index has exactly this many rows (the last
    one zero-padded), one process or sharded, so a row's score has the
    same bits on any number of ranks."""
    return min(1 << 16, 1 << max(0, (n - 1).bit_length()))


class RetrievalIndex:
    """Device-resident normalized, logit_scale-premultiplied index, on the
    card unless `device` names another (as `load_gill`); with `mesh`, this
    data rank's block of rows: whole score windows, the last rank's padded
    with zero rows. `matrix` is the block's real rows."""

    def __init__(self, paths: Sequence[str], emb_matrix, logit_scale: float,
                 device="cuda", mesh=None):
        self.paths = list(paths)
        self.n = len(emb_matrix)
        if len(self.paths) != self.n:
            raise ValueError(f"{len(self.paths)} paths for {self.n} rows")
        self.group = data_group(mesh)
        self.window = w = score_window(self.n)
        shards = 1 if self.group is None else mesh.dp
        self.rows = -(-self.n // (shards * w)) * w          # padded rows
        self.offset = 0 if self.group is None else mesh.dp_rank * self.rows
        lo, hi = min(self.offset, self.n), min(self.offset + self.rows,
                                               self.n)
        self.real = hi - lo                     # rows of the block < n
        self._block = torch.zeros((self.rows, emb_matrix.shape[1]),
                                  device=device, dtype=torch.float32)
        # normalized in windows on global multiples of w (equal shapes on
        # any number of ranks)
        for a in range(lo, hi, w):
            b = min(a + w, hi)
            x = torch.as_tensor(emb_matrix[a:b], device=device).float()
            self._block[a - lo:b - lo] = (x / torch.linalg.vector_norm(
                x, dim=1, keepdim=True)) * float(logit_scale)

    @property
    def matrix(self):
        return self._block[:self.real]

    def _scores(self, q, seen_idx):
        """(B, rows) scores of this block's rows: w-row products, -inf on
        the pad rows (the block's tail), -1000 per seen hit inside the
        block's range (gill_tpu's shard form, s - 1000 x count)."""
        lo, w = self.offset, self.window
        s = torch.empty((q.shape[0], self.rows), device=q.device)
        for a in range(0, self.rows, w):
            s[:, a:a + w] = q @ self._block[a:a + w].t()
        s[:, self.real:] = -torch.inf
        for i, seen in enumerate(seen_idx or ()):
            mine = [j - lo for j in seen if lo <= j < lo + self.real]
            if mine:
                ids, count = torch.as_tensor(mine, device=q.device).unique(
                    return_counts=True)
                s[i, ids] = s[i, ids] - 1000.0 * count.float()
        return s

    def topk_batch(self, queries, k: int = 3,
                   seen_idx: Optional[Sequence[Sequence[int]]] = None):
        """(B, D) queries -> (scores (B, k), indices (B, k)) as numpy;
        `seen_idx[b]` lists rows to downweight for query b. Under a mesh
        each data rank's top-k of its block, merged over "data"."""
        q = torch.as_tensor(queries, device=self._block.device).float()
        if q.ndim != 2:
            raise ValueError(f"queries must be (B, D), got {tuple(q.shape)}")
        if k > self.rows:
            raise ValueError(f"k {k} exceeds the {self.rows} rows a block")
        v, i = torch.topk(self._scores(q, seen_idx), k, dim=-1)
        if self.group is not None:
            n = dist.get_world_size(self.group)
            gi = i + self.offset
            vs = [torch.empty_like(v) for _ in range(n)]
            gs = [torch.empty_like(gi) for _ in range(n)]
            dist.all_gather(vs, v.contiguous(), group=self.group)
            dist.all_gather(gs, gi.contiguous(), group=self.group)
            v, pos = torch.topk(torch.cat(vs, 1), k, dim=-1)
            i = torch.gather(torch.cat(gs, 1), 1, pos)
        return v.cpu().numpy(), i.cpu().numpy()

    def topk(self, query, k: int = 3, seen_idx: Sequence[int] = ()):
        """(D,) query -> (scores (k,), indices (k,))."""
        q = torch.as_tensor(query).reshape(1, -1)
        scores, idx = self.topk_batch(q, k, [seen_idx])
        return scores[0], idx[0]

    def scores_for(self, query, idx: Sequence[int]) -> np.ndarray:
        """The scores of rows `idx` (global ids); under a mesh each data
        rank scores the rows of its block and the scores are summed over
        "data" (every other rank adds 0)."""
        dev = self._block.device
        q = torch.as_tensor(query, device=dev).float()
        ids = torch.as_tensor(list(idx), dtype=torch.long, device=dev)
        if self.group is None:
            return (self.matrix[ids] @ q).cpu().numpy()
        local = (ids >= self.offset) & (ids < self.offset + self.real)
        rows = self._block[(ids - self.offset).clamp(0, self.rows - 1)]
        out = torch.where(local, rows @ q,
                          torch.zeros_like(ids, dtype=q.dtype))
        dist.all_reduce(out, group=self.group)
        return out.cpu().numpy()


def save_embeddings(out_path: str, paths: Sequence[str], embeddings):
    """Writes the reference-compatible pickled {'paths', 'embeddings'} blob
    (scripts/extract_img_embs.py's format) that `load_embeddings` reads."""
    if torch.is_tensor(embeddings):
        embeddings = embeddings.detach().float().cpu().numpy()
    with open(out_path, "wb") as f:
        pickle.dump({"paths": list(paths),
                     "embeddings": np.asarray(embeddings)}, f)
