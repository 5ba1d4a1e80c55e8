"""The port's training CLI on two gloo ranks of CPU processes at
`--dp-size 2 --ckpt-backend orbax` (gill_tpu's
tests/test_multihost.py::test_two_process_cli_orbax_resume): a run
interrupted after epoch 0 and resumed from its collective `orbax_<step>/`
checkpoint ends bit for bit equal to an uninterrupted two-epoch run
(adapters and optimizer state), both ranks read the same state back,
rank 0 alone writes the run directory's TensorBoard events, and
`meta.json` carries the step and epoch. The ranks call
`gill_tpu_torch.main.main` in-process (tests/torch_dist_cases.py)."""

import glob
import os

from gill_tpu_torch.data import dataset as tdata

import torch_dist_cases as cases
from test_torch_train_cli import _cli_args


def test_two_rank_cli_orbax_resume_is_bitwise(tmp_path):
    root, runs = str(tmp_path / "data"), str(tmp_path / "runs")
    for split, n in (("train", 8), ("val", 4)):
        tdata.make_stub_dataset(root, n=n, image_size=16, num_clip_tokens=4,
                                split=split)
    # a linear generation head (4 CLIP tokens, one a [IMG] token) keeps
    # the adapters, and each checkpoint, small
    common = ["--dp-size", "2", "--ckpt-backend", "orbax", "--batch-size",
              "4", "--steps-per-epoch", "2", "--concat-captions-prob", "1.0",
              "--text-fc-mode", "linear", "--num-clip-tokens", "4"]
    full = _cli_args(root, runs, "full", *common, "--epochs", "2")
    first = _cli_args(root, runs, "first", *common, "--epochs", "1")
    resume = _cli_args(root, runs, "resumed", *common, "--epochs", "2")
    res = cases.run("cli_resume", 2, tmp_path / "ranks", timeout=400,
                    argv_full=full, argv_first=first,
                    argv_resume_head=resume)
    for out in res:
        assert out["dirs"] == res[0]["dirs"]
        full, first, resumed = out["metas"]
        assert (first["step"], first["epoch"]) == (2, 1)
        assert (full["step"], resumed["step"], resumed["epoch"]) == (4, 4, 2)
        assert out["leaves"] > 0 and out["resumed_equal"]
        # the first run's state is not the final one (the resume trained)
        assert out["first_differs"]
        assert out["digest"] == res[0]["digest"]
    assert sorted(os.listdir(runs)) == ["first", "full", "resumed"]
    for d in res[0]["dirs"]:
        assert len(glob.glob(os.path.join(d, "events.out.tfevents.*"))) == 1
        assert os.path.exists(os.path.join(d, "args.json"))
    assert os.path.exists(os.path.join(runs, "full", "orbax_4", "meta.json"))
    assert not glob.glob(os.path.join(runs, "*", "ckpt"))
