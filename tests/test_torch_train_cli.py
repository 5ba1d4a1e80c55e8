"""The port's training surroundings against gill_tpu's: the stub dataset and
the DataLoader's batches, BLEU and the meters, TensorBoard events,
checkpoints, `validate`, and `python -m gill_tpu_torch.main` on the CPU at
tiny widths. gill_tpu's own functions read or reproduce what the port
writes. Tolerance for validate's metrics: rtol 1e-4 / atol 1e-5 (the
train-step tests' fp32 tolerance); everything else is compared exactly."""

import glob
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from gill_tpu.config import TrainConfig as JTrainConfig
from gill_tpu.data import dataset as jdata
from gill_tpu.tokenizer import GPT2BPETokenizer as JTok
from gill_tpu.tokenizer import setup_gill_tokenizer as jsetup
from gill_tpu.train import bleu as jbleu
from gill_tpu.train import validate as jvalidate
from gill_tpu.utils import ckpt as jckpt
from gill_tpu.utils import meters as jmeters
from gill_tpu.utils import tb as jtb
from gill_tpu_torch import config as tcfg
from gill_tpu_torch.data import dataset as tdata
from gill_tpu_torch.tokenizer import GPT2BPETokenizer as TTok
from gill_tpu_torch.tokenizer import setup_gill_tokenizer as tsetup
from gill_tpu_torch.train import bleu as tbleu
from gill_tpu_torch.train import trainer as ttrainer
from gill_tpu_torch.train import validate as tvalidate
from gill_tpu_torch.utils import ckpt as tckpt
from gill_tpu_torch.utils import meters as tmeters
from gill_tpu_torch.utils import tb as ttb
from gill_tpu_torch.weights import from_jax
from test_torch_train_step import TC, make_batch, setup  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(root, **kw):
    class A:
        dataset = val_dataset = "cc3m"
        dataset_dir = os.path.join(root, "datasets")
        image_dir = root
        max_len = 16
        image_size = 16
        num_clip_tokens = 8
        gen_emb_dim = 12
    for k, v in kw.items():
        setattr(A, k, v)
    return A


@pytest.mark.parametrize("split", ["train", "val"])
def test_stub_dataset_and_batches_match_gill_tpu(tmp_path, monkeypatch, split):
    """The same stub files, and with one seed the same batches in the same
    order (gill_tpu decodes with PIL too, GILL_NO_NATIVE_IMAGE=1)."""
    monkeypatch.setenv("GILL_NO_NATIVE_IMAGE", "1")
    a, b = str(tmp_path / "j"), str(tmp_path / "t")
    jdata.make_stub_dataset(a, n=10, image_size=20, split=split)
    tdata.make_stub_dataset(b, n=10, image_size=20, split=split)
    for fa in sorted(glob.glob(os.path.join(a, "**", "*.*"), recursive=True)):
        fb = fa.replace(a, b, 1)
        with open(fa, "rb") as x, open(fb, "rb") as y:
            assert x.read() == y.read(), fa
    jt, tt = JTok.tiny(), TTok.tiny()
    ids = jsetup(jt, 4)
    assert tsetup(tt, 4) == ids
    jds = jdata.get_dataset(_args(a), split, jt, ids)
    tds = tdata.get_dataset(_args(b), split, tt, ids)
    shuffle = split == "train"
    jl = jdata.DataLoader(jds, 3, shuffle=shuffle, seed=5, num_threads=2,
                          drop_last=shuffle)
    tl = tdata.DataLoader(tds, 3, shuffle=shuffle, seed=5, num_threads=2,
                          drop_last=shuffle)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == len(jl) == len(tl) > 0
        for x, y in zip(jb, tb):
            assert set(x) == set(y)
            assert [p.replace(a, b, 1) for p in x["path"]] == y["path"]
            for k in x:
                if k != "path":
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_bleu_and_meters_match_gill_tpu(capsys):
    cands = ["a dog on a red house", "small cat", "", "the tree is big big"]
    refs = ["a dog near a red house", "a small cat", "cat", "the big tree"]
    assert tbleu.bleu_score(cands, refs) == jbleu.bleu_score(cands, refs)
    assert tbleu.bleu_score(cands[:1], refs[:1], max_n=2) == \
        jbleu.bleu_score(cands[:1], refs[:1], max_n=2)
    out = []
    for mod in (jmeters, tmeters):
        m = [mod.AverageMeter("loss", ":.4e"),
             mod.AverageMeter("n", ":6.2f", mod.Summary.SUM),
             mod.AverageMeter("c", summary_type=mod.Summary.COUNT)]
        for i, v in enumerate((0.5, 1.25, 3.0)):
            for meter in m:
                meter.update(v, n=i + 1)
        p = mod.ProgressMeter(12, m, prefix="Epoch: [0]")
        p.display(3)
        p.display_summary()
        out.append((capsys.readouterr().out, [str(x) for x in m],
                    [x.summary() for x in m]))
    assert out[0] == out[1]


def test_tensorboard_events_read_by_gill_tpu(tmp_path):
    w = ttb.SummaryWriter(str(tmp_path))
    w.add_scalar("train/loss", 1.5, 1)
    w.add_scalar("val/top1", 12.25, 2)
    img = np.random.RandomState(0).rand(3, 10, 14).astype(np.float32)
    w.add_image("train/images_gen_cap", img, 1)
    w.close()
    (path,) = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    events = jtb.read_events(path, verify_crc=True)
    assert events == ttb.read_events(path, verify_crc=True)
    assert events[0]["file_version"] == "brain.Event:2"
    assert events[1]["scalars"] == {"train/loss": 1.5}
    assert events[2]["scalars"] == {"val/top1": 12.25}
    assert (events[2]["step"], events[3]["step"]) == (2, 1)
    png = events[3]["images"]["train/images_gen_cap"]
    assert png == jtb.encode_png_rgb(
        (np.clip(img, 0, 1).transpose(1, 2, 0) * 255 + 0.5).astype(np.uint8))


def test_checkpoint_read_by_gill_tpu(setup, tmp_path):
    s = setup
    tct = tcfg.TrainConfig(**TC)
    state = ttrainer.init_state(tct, from_jax.adapters_from_jax(
        s["params"]["adapters"]))
    state, _ = ttrainer.make_train_step(s["tc"], tct)(
        state, s["frozen_t"], ttrainer.put_batch(s["batch"], "cpu"))
    tckpt.save_checkpoint(ttrainer.state_tree(state), str(tmp_path),
                          step=state.step, is_best=True,
                          meta={"epoch": 1, "best_acc1": 2.5})
    for sub in ("ckpt", "ckpt_best"):
        tree, meta = jckpt.load_checkpoint(str(tmp_path / sub))
        assert meta == {"step": 1, "epoch": 1, "best_acc1": 2.5}
        want = from_jax.tree_to_numpy(state.adapters)
        assert set(jckpt._flatten(tree["adapters"])) == \
            set(jckpt._flatten(want))
        for k, v in jckpt._flatten(want).items():
            np.testing.assert_array_equal(
                jckpt._flatten(tree["adapters"])[k], v, err_msg=k)
    # gill_tpu's adapter keys are the port's
    assert set(tckpt._flatten(state.adapters)) == \
        set(jckpt._flatten(s["params"]["adapters"]))


class _Writer:
    def __init__(self):
        self.scalars, self.images = {}, {}

    def add_scalar(self, tag, value, step):
        self.scalars[tag] = (float(value), step)

    def add_image(self, tag, img, step):
        self.images[tag] = (np.asarray(img), step)


def test_validate_matches_gill_tpu(setup):
    s = setup
    jt, tt = JTok.tiny(), TTok.tiny()
    batches = [make_batch(b=4, seed=7), make_batch(b=4, seed=8)]
    prefix = np.array([10, 11, 12], np.int32)
    wj, wt = _Writer(), _Writer()
    with redirect_stdout(io.StringIO()):
        got = tvalidate.validate(
            s["tc"], tcfg.TrainConfig(**TC),
            from_jax.adapters_from_jax(s["params"]["adapters"]),
            s["frozen_t"], batches, tt, epoch=2, writer=wt,
            prefix_ids=torch.from_numpy(prefix).long(), device="cpu")
        want = jvalidate.validate(
            s["jc"], JTrainConfig(**TC),
            jax.tree_util.tree_map(np.asarray, s["params"]["adapters"]),
            s["frozen_j"], [dict(b) for b in batches], jt, epoch=2,
            writer=wj, prefix_ids=prefix)
    assert got == pytest.approx(want)
    assert set(wt.scalars) == set(wj.scalars)
    assert "val/bleu4" in wt.scalars and "val/t2i_top5" in wt.scalars
    for k, (v, step) in wj.scalars.items():
        assert step == 3
        np.testing.assert_allclose(wt.scalars[k][0], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(wt.images["val/images_captioning"][0],
                                  wj.images["val/images_captioning"][0])


def _cli_args(root, runs, exp, *extra):
    return ["--opt-version", "test/opt-tiny", "--visual-model",
            "test/clip-tiny", "--dataset-dir", f"{root}/datasets",
            "--image-dir", root, "--log-base-dir", runs, "--exp-name", exp,
            "--precision", "fp32", "--batch-size", "2",
            "--val-batch-size", "2", "--epochs", "1", "--steps-per-epoch",
            "4", "--val-steps-per-epoch", "1", "--num-tokens", "4",
            "--num-clip-tokens", "8", "--gen-emb-dim", "12",
            "--ret-emb-dim", "8", "--n-visual-tokens", "2", "--max-len",
            "16", "--image-size", "16", "--lr-warmup-steps", "2",
            "--print-freq", "2", "--seed", "42", "--workers", "1",
            "--concat-captions-prob", "0.5", "--device", "cpu", *extra]


def test_cli_trains_validates_and_checkpoints_on_cpu(tmp_path):
    root, runs = str(tmp_path / "data"), str(tmp_path / "runs")
    tdata.make_stub_dataset(root, n=8, image_size=16, split="train")
    tdata.make_stub_dataset(root, n=4, image_size=16, split="val")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "gill_tpu_torch.main",
         *_cli_args(root, runs, "smoke"), "--profile-steps", "2"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "Epoch: [0]" in res.stdout and " * val/loss=" in res.stdout
    assert "jax" not in res.stderr
    log_dir = os.path.join(runs, "smoke")
    for f in ("args.json", "model_args.json", "param_count.txt",
              "ckpt/state.npz", "ckpt/meta.json", "ckpt_best/state.npz",
              "trace/trace.json"):
        assert os.path.exists(os.path.join(log_dir, f)), f
    with open(os.path.join(log_dir, "ckpt", "meta.json")) as f:
        assert json.load(f)["step"] == 4
    (ev,) = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    events = jtb.read_events(ev, verify_crc=True)
    scalars = {t for e in events for t in e["scalars"]}
    images = {t for e in events for t in e["images"]}
    assert {"train/loss", "train/grad_norm", "train/lr", "val/top1",
            "val/bleu1", "metrics/examples_per_sec"} <= scalars
    assert images == {"train/images_gen_cap", "train/t2i_ret",
                      "train/i2t_ret", "val/images_captioning"}
    tree, meta = jckpt.load_checkpoint(log_dir)
    assert meta["epoch"] == 1 and "opt_state" in tree
    assert int(tree["opt_state"]["count"]) == 4


@pytest.mark.parametrize("flag", [["--tp-size", "2"], ["--dp-size", "2"],
                                  ["--multihost"],
                                  ["--ckpt-backend", "orbax"]])
def test_cli_refuses_what_is_not_ported(flag):
    from gill_tpu_torch import main as tmain

    with pytest.raises(NotImplementedError, match="Q1.8"):
        tmain.main(flag)


def test_cli_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    from gill_tpu_torch import main as tmain

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tmain.main(["--log-base-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
