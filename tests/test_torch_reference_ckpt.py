"""The reference's `pretrained_ckpt.pth.tar` adapter import
(gill_tpu_torch/utils/ckpt.py load_reference_gill_checkpoint) against
gill_tpu's (mirrors test_components.py::test_reference_gill_ckpt_import):
the same file, with DDP `module.` prefixes and one ret/gen mapper pair per
LM tap, gives equal adapter trees leaf for leaf (np.array_equal). Also
chip_smoke.py's writer of such files (`adapters_to_reference`), which phase
G loads on the card, round-trips a port adapter tree exactly."""

import dataclasses

import numpy as np
import pytest
import torch
from torch import nn as tnn

import chip_smoke
from gill_tpu_torch.nn.core import Init
from gill_tpu_torch.weights.from_jax import tree_to_numpy


def _cores(taps):
    from gill_tpu.models.gill import GILLCore as JCore
    from gill_tpu_torch import config as tcfg
    from gill_tpu_torch.models.gill import GILLCore as TCore
    from test_gill_forward import make_core

    jcore = make_core()
    jcore = dataclasses.replace(jcore, cfg=dataclasses.replace(
        jcore.cfg, text_emb_layers=taps))
    assert isinstance(jcore, JCore)
    tcfg_ = tcfg.GILLConfig.from_json(jcore.cfg.to_json())
    tcore = TCore(cfg=tcfg_, opt_cfg=tcfg.OPTConfig(
        **dataclasses.asdict(jcore.opt_cfg)),
        vis_cfg=tcfg.CLIPVisionConfig(**dataclasses.asdict(jcore.vis_cfg)),
        vocab_len=jcore.vocab_len, img_start=jcore.img_start,
        pad_token_id=jcore.pad_token_id, bos_token_id=jcore.bos_token_id)
    assert tcore.tap_specs() == jcore.tap_specs()
    return jcore, tcore


def _reference_file(path, core, prefix="module."):
    from test_mapper import TorchTextFc

    torch.manual_seed(0)
    sd = {"model.input_embeddings.weight": torch.randn(core.vocab_len,
                                                       core.lm_dim),
          "model.logit_scale": torch.tensor(2.5)}
    vh = core.vis_cfg.hidden_size
    for name, lin in (("visual_embeddings", tnn.Linear(
            vh, core.lm_dim * core.cfg.n_visual_tokens)),
            ("visual_fc", tnn.Linear(vh, core.cfg.ret_emb_dim))):
        sd.update({f"model.{name}.{k}": v for k, v in lin.state_dict().items()})
    for i, (_, _, in_dim) in enumerate(core.tap_specs()):
        ret = TorchTextFc(in_dim, core.cfg.ret_emb_dim, 1, "linear")
        gen = TorchTextFc(in_dim, core.cfg.gen_emb_dim,
                          core.cfg.num_clip_tokens, "gill_mapper", hidden=512,
                          nhead=4, ff=2048, n_enc=4, n_dec=4)
        sd.update({f"model.ret_text_hidden_fcs.{i}.{k}": v
                   for k, v in ret.state_dict().items()})
        sd.update({f"model.gen_text_hidden_fcs.{i}.{k}": v
                   for k, v in gen.state_dict().items()})
    torch.save({"state_dict": {prefix + k: v for k, v in sd.items()}}, path)
    return sd


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert np.array_equal(g, w), path


@pytest.mark.parametrize("taps,prefix", [((-1,), "module."), ((-1,), ""),
                                         ((-1, 1), "module.")])
def test_reference_ckpt_matches_gill_tpu(tmp_path, taps, prefix):
    from gill_tpu.utils.ckpt import load_reference_gill_checkpoint as jload
    from gill_tpu_torch.utils.ckpt import load_reference_gill_checkpoint

    jcore, tcore = _cores(taps)
    path = str(tmp_path / "pretrained_ckpt.pth.tar")
    sd = _reference_file(path, jcore, prefix)
    want = jload(path, jcore)
    got = load_reference_gill_checkpoint(path, tcore)
    _assert_tree_equal(got, want)
    nt = tcore.cfg.num_tokens
    np.testing.assert_array_equal(
        got["img_embeddings"], sd["model.input_embeddings.weight"][-nt:])
    assert got["gen_fc"]["query_embs"].shape == (1, tcore.cfg.num_clip_tokens,
                                                 512)
    assert ("gen_fc_1" in got) == (len(taps) == 2)


def test_chip_smoke_reference_writer_round_trips(tmp_path):
    from gill_tpu_torch.utils.ckpt import load_reference_gill_checkpoint

    _, core = _cores((-1,))
    adapters = core.init_adapters(Init(torch.Generator().manual_seed(3),
                                       "cpu"))
    nt = core.cfg.num_tokens
    table = torch.randn(core.vocab_len, core.lm_dim)
    table[-nt:] = adapters["img_embeddings"]
    sd = chip_smoke.adapters_to_reference(adapters, core, table)
    assert all(k.startswith("module.model.") for k in sd)
    path = str(tmp_path / "pretrained_ckpt.pth.tar")
    torch.save({"state_dict": sd}, path)
    got = load_reference_gill_checkpoint(path, core)
    want = tree_to_numpy(adapters)
    want["logit_scale"] = want["logit_scale"].reshape(())  # 0-d in the file
    _assert_tree_equal(got, want)
