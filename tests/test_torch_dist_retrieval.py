"""The sharded retrieval index against gill_tpu's (gill_tpu/retrieval.py
`_topk_shard_merge` under a ("data",) mesh of dp CPU devices, and its
single-device top-k): at dp 2 and dp 3, with n not a multiple of dp (pad
rows), seen ids inside and across blocks (one repeated), and blocks that
hold pad rows only (n 7 over 3 ranks). Ids equal, scores within 1e-6 of
gill_tpu's; the port's sharded top-k bit for bit its one-process top-k;
every rank returns the same."""

import jax
import numpy as np
import pytest

from gill_tpu.parallel import create_mesh as jmesh
from gill_tpu.retrieval import RetrievalIndex as JIndex
from gill_tpu_torch.retrieval import RetrievalIndex as TIndex

import torch_dist_cases as cases


def _data(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 16).astype(np.float32),
            rng.randn(3, 16).astype(np.float32))


def _jtopk(mat, queries, k, seen, dp=None):
    mesh = None if dp is None else jmesh(dp, 1, devices=jax.devices()[:dp])
    idx = JIndex([str(i) for i in range(len(mat))], mat, 2.5, mesh=mesh)
    return idx.topk_batch(queries, k, seen)


@pytest.mark.parametrize("dp,n,k", [(2, 101, 5), (3, 100, 4), (3, 7, 3)])
def test_sharded_topk_matches_gill_tpu(tmp_path, dp, n, k):
    mat, queries = _data(n, seed=dp)
    seen = [[0, n - 1, n // 2], [n // 2, n // 2], [1]]
    want_mesh = _jtopk(mat, queries, k, seen, dp)
    want_one = _jtopk(mat, queries, k, seen)
    res = cases.run("sharded_topk", dp, tmp_path, mat=mat, scale=2.5,
                    queries=queries, k=k, seen=seen)
    mine = TIndex([str(i) for i in range(n)], mat, 2.5, device="cpu") \
        .topk_batch(queries, k, seen)
    for out in res:
        assert out["rows"] * dp >= n
        np.testing.assert_array_equal(out["ids"], mine[1])
        np.testing.assert_array_equal(out["vals"], mine[0])
        for want in (want_mesh, want_one):
            np.testing.assert_array_equal(out["ids"], want[1])
            np.testing.assert_allclose(out["vals"], want[0], rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_array_equal(out["ids"], res[0]["ids"])
        m = mat[[0, n - 1]] / np.linalg.norm(mat[[0, n - 1]], axis=1,
                                             keepdims=True) * 2.5
        np.testing.assert_allclose(out["scores_for"], m @ queries[0],
                                   rtol=1e-5)
