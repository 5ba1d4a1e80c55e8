"""The port's parallel layer against gill_tpu's: `param_pspecs` equal to
gill_tpu.parallel.partition.param_pspecs case for case (as
tests/test_tp_decode.py's `test_partition_specs_shapes`), and on a
(2, 2) gloo group of CPU processes: shard then gather gives the tree
back, Megatron's copy / reduce pair and the data all-gather give the
one-process values and gradients (float64, to 1e-12), `gather_rows`
takes ragged counts, `broadcast_str`, and `AverageMeter.all_reduce` sums
(sum, count) as gill_tpu's process_allgather does. The ranks import only
torch and gill_tpu_torch (tests/torch_dist_cases.py); groups rendezvous
through a file store under tmp_path with a process-group timeout and a
join limit."""

import jax
import pytest

from gill_tpu.parallel.partition import param_pspecs as jspecs
from gill_tpu_torch.parallel import Mesh, create_mesh
from gill_tpu_torch.parallel import partition as P
from gill_tpu_torch.weights import from_jax

import torch_dist_cases as cases
from test_torch_dist_train import CORE_KW

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture(scope="module")
def params():
    return cases.make_params(CORE_KW, 0)


def _by_path(tree, is_spec):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]}


def test_partition_rules_match_gill_tpu(params):
    """Every leaf's spec as gill_tpu's PartitionSpec reads, on the GILL
    tree, the bare LM tree and a W8-free layer subtree."""
    tparams = from_jax.gill_params_from_jax(params)
    for jt, tt in ((params, tparams), (params["lm"], tparams["lm"]),
                   ({"lm": {"layers": params["lm"]["layers"]}},
                    {"lm": {"layers": tparams["lm"]["layers"]}})):
        want = _by_path(jspecs(jt), lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        got = _by_path(P.param_pspecs(tt), lambda x: isinstance(x, tuple))
        assert set(got) == set(want)
        for k, spec in want.items():
            assert got[k] == tuple(spec), k
    specs = P.param_pspecs(tparams)
    assert specs["lm"]["layers"]["attn"]["q"]["w"] == (None, None, "model")
    assert specs["lm"]["layers"]["attn"]["o"]["w"] == (None, "model", None)
    assert specs["lm"]["layers"]["fc1"]["b"] == (None, "model")
    assert specs["lm"]["layers"]["fc2"]["b"] == ()
    assert specs["vision"]["layers"]["attn"]["q"]["w"] == ()


def test_single_device_mesh_and_refusals(params):
    """No process group: the (1, 1) mesh with no groups, whose shards are
    the tree itself; W8 leaves raise as gill_tpu's mesh refuses them."""
    from gill_tpu_torch.models import opt as topt

    mesh = create_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.model is None
    lm = from_jax.opt_from_jax(params["lm"])
    assert P.shard_params(lm, mesh)["layers"]["fc1"]["w"] is \
        lm["layers"]["fc1"]["w"]
    with pytest.raises(ValueError, match="mesh mode requires bf16"):
        P.shard_params(topt.quantize_params_w8(lm), Mesh(
            {"data": 1, "model": 2}, 0, (0, 0)))
    with pytest.raises(ValueError, match="dp_size 3 x tp_size 1"):
        create_mesh(3, 1)



def test_shard_params_copies_each_slice_to_the_device(params):
    """A model rank's slices are fresh copies on `device` (one layer, so a
    slice of a leading split dimension is contiguous in the full tree and
    could otherwise stay a view of it); unsplit leaves are moved."""
    import torch

    lm = from_jax.opt_from_jax(params["lm"])
    one = torch.Generator().manual_seed(0)
    lm["layers"] = {"attn": {"q": {"w": torch.randn(1, 8, 6, generator=one),
                                   "b": torch.randn(1, 6, generator=one)}},
                    "fc2": {"w": torch.randn(1, 6, 8, generator=one)}}
    full = lm["layers"]
    for r in range(2):
        got = P.shard_params(lm, Mesh({"data": 1, "model": 2}, r, (0, r)),
                             device="cpu")["layers"]
        assert torch.equal(got["attn"]["q"]["w"],
                           full["attn"]["q"]["w"][..., 3 * r:3 * r + 3])
        assert torch.equal(got["fc2"]["w"],
                           full["fc2"]["w"][:, 3 * r:3 * r + 3])
        for leaf in (got["attn"]["q"]["w"], got["fc2"]["w"]):
            assert leaf.is_contiguous()
            assert leaf.untyped_storage().data_ptr() not in {
                t.untyped_storage().data_ptr() for t in
                (full["attn"]["q"]["w"], full["fc2"]["w"])}

def test_shard_gather_and_collectives_on_four_ranks(params, tmp_path):
    res = cases.run("partition_and_collectives", 4, tmp_path,
                    core_kw=CORE_KW, seed=0, dp=2, tp=2)
    q = params["lm"]["layers"]["attn"]["q"]["w"].shape
    for r, out in enumerate(res):
        assert out["coords"] == divmod(r, 2)
        assert out["q_shape"] == (q[0], q[1], q[2] // 2)
        assert out["round_trip"]
        assert out["tp_y_err"] < 1e-12 and out["tp_grad_err"] < 1e-12
        assert out["gather_err"] == 0 and out["gather_grad_err"] < 1e-12
        # the data group of model coordinate r % 2 holds ranks r % 2 (one
        # row) and r % 2 + 2 (two rows), rank-major
        assert out["rows"].tolist() == [0, 0, 1]
        assert out["str"] == "run_3"
        # gill_tpu's all_reduce: sums of (sum, count) over the processes
        s = sum((i + 1) * (i + 2) for i in range(4))
        n = sum(i + 2 for i in range(4))
        assert out["meter"] == pytest.approx((s, n, s / n))
        # every rank's adapters are drawn, not broadcast: `replicated`
        # passes equal trees and refuses one that differs on rank 3
        assert out["replicated"]
        assert "differs across ranks" in out["replicated_refused"]


@pytest.mark.parametrize("split,rank", [("train", 0), ("train", 1),
                                        ("val", 1)])
def test_loader_shards_match_gill_tpu(tmp_path, monkeypatch, split, rank):
    """The DataLoader's interleaved shard (rank of world 2, the
    DistributedSampler equivalent the CLI gives each data coordinate):
    gill_tpu's batches for that rank, paths and arrays, on 7 examples (the
    wrap that equalizes the ranks' counts)."""
    import glob
    import os

    import numpy as np

    from gill_tpu.data import dataset as jdata
    from gill_tpu.tokenizer import GPT2BPETokenizer as JTok
    from gill_tpu.tokenizer import setup_gill_tokenizer as jsetup
    from gill_tpu_torch.data import dataset as tdata
    from gill_tpu_torch.tokenizer import GPT2BPETokenizer as TTok
    from gill_tpu_torch.tokenizer import setup_gill_tokenizer as tsetup
    from test_torch_train_cli import _args

    monkeypatch.setenv("GILL_NO_NATIVE_IMAGE", "1")
    a, b = str(tmp_path / "j"), str(tmp_path / "t")
    jdata.make_stub_dataset(a, n=7, image_size=16, split=split)
    tdata.make_stub_dataset(b, n=7, image_size=16, split=split)
    assert glob.glob(os.path.join(b, "**", "*.png"), recursive=True)
    jt, tt = JTok.tiny(), TTok.tiny()
    ids = jsetup(jt, 4)
    assert tsetup(tt, 4) == ids
    shuffle = split == "train"
    kw = dict(shuffle=shuffle, seed=5, num_threads=1, rank=rank, world=2,
              drop_last=shuffle)
    jl = jdata.DataLoader(jdata.get_dataset(_args(a), split, jt, ids), 2,
                          **kw)
    tl = tdata.DataLoader(tdata.get_dataset(_args(b), split, tt, ids), 2,
                          **kw)
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) > 0
    for x, y in zip(jb, tb):
        assert [p.replace(a, b, 1) for p in x["path"]] == y["path"]
        for k in x:
            if k != "path":
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
