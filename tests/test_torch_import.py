"""gill_tpu_torch imports without JAX, triton or a GPU, and its jax-free
re-declarations (configs, tokenizer, image and checkpoint utilities) equal
their gill_tpu originals."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import gill_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gill_tpu_torch.__path__,
                                               "gill_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "gill_tpu", "triton",
                                    "scripts"))
print(len(names), bad)
assert len(names) >= 20, names
for needed in ("gill_tpu_torch.serve.engine", "gill_tpu_torch.serve.gill_engine",
               "gill_tpu_torch.ops.w8_matmul", "gill_tpu_torch.ops.decode_attn",
               "gill_tpu_torch.ops.quant", "gill_tpu_torch.ops.ln_matmul",
               "gill_tpu_torch.serve.sd_queue", "gill_tpu_torch.ops.mm_probe",
               "gill_tpu_torch.ops.flash_variants",
               "gill_tpu_torch.scripts._timing",
               "gill_tpu_torch.scripts.attn_mxu_probe",
               "gill_tpu_torch.scripts.attn_sweep",
               "gill_tpu_torch.scripts.int8_probe",
               "gill_tpu_torch.scripts.profile_sd",
               "gill_tpu_torch.scripts.profile_sd_ablate",
               "gill_tpu_torch.scripts.profile_ln_fuse",
               "gill_tpu_torch.scripts.profile_prefix_decode"):
    assert needed in names, needed
assert not bad, bad
"""


def test_package_imports_without_jax():
    """A fresh interpreter (this test process already holds jax) imports
    every submodule; no jax, gill_tpu or triton module gets loaded."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _config_pairs():
    from gill_tpu import config as jcfg
    from gill_tpu.models import clip as jclip
    from gill_tpu.models import mapper as jmapper
    from gill_tpu.models.sd import pipeline as jpipe
    from gill_tpu.models.sd import scheduler as jsched
    from gill_tpu.models.sd import unet as junet
    from gill_tpu.models.sd import vae as jvae
    from gill_tpu_torch import config as tcfg

    pairs = [
        ("GILLConfig", jcfg.GILLConfig(), tcfg.GILLConfig()),
        ("UNetConfig", junet.UNetConfig(), tcfg.UNetConfig()),
        ("tiny_unet_config", junet.tiny_unet_config(),
         tcfg.tiny_unet_config()),
        ("VAEConfig", jvae.VAEConfig(), tcfg.VAEConfig()),
        ("tiny_vae_config", jvae.tiny_vae_config(), tcfg.tiny_vae_config()),
        ("CLIPTextConfig", jclip.CLIPTextConfig(), tcfg.CLIPTextConfig()),
        ("MapperConfig", jmapper.MapperConfig(in_dim=7, out_dim=5),
         tcfg.MapperConfig(in_dim=7, out_dim=5)),
        ("SchedulerConfig", jsched.SchedulerConfig(), tcfg.SchedulerConfig()),
        ("SDPipelineConfig", jpipe.SDPipelineConfig(),
         tcfg.SDPipelineConfig()),
        ("tiny_sd_config", jpipe.tiny_sd_config(), tcfg.tiny_sd_config()),
    ]
    for name in jcfg.OPT_PRESETS:
        pairs.append((f"OPT:{name}", jcfg.OPTConfig.from_name(name),
                      tcfg.OPTConfig.from_name(name)))
    for name in jcfg.CLIP_VISION_PRESETS:
        pairs.append((f"CLIP:{name}", jcfg.CLIPVisionConfig.from_name(name),
                      tcfg.CLIPVisionConfig.from_name(name)))
    return pairs


@pytest.mark.parametrize("idx", range(len(_config_pairs())))
def test_config_matches_gill_tpu(idx):
    name, jax_cfg, torch_cfg = _config_pairs()[idx]
    assert type(jax_cfg).__name__ == type(torch_cfg).__name__, name
    assert dataclasses.asdict(jax_cfg) == dataclasses.asdict(torch_cfg), name
    assert [f.name for f in dataclasses.fields(jax_cfg)] == \
        [f.name for f in dataclasses.fields(torch_cfg)], name


def test_gill_config_json_roundtrip_and_idx2dec():
    from gill_tpu import config as jcfg
    from gill_tpu.models.decision import IDX2DEC as J_IDX2DEC
    from gill_tpu_torch import config as tcfg
    from gill_tpu_torch.models.decision import IDX2DEC

    cfg = jcfg.GILLConfig(opt_version="test/opt-tiny", num_tokens=4,
                          text_emb_layers=(-1,))
    assert tcfg.GILLConfig.from_json(cfg.to_json()).to_json() == cfg.to_json()
    assert IDX2DEC == J_IDX2DEC


def _bpe_vocab():
    """Byte-level vocab plus a few merged symbols, so the BPE merge loop
    runs (the tiny tokenizer has no merges)."""
    from gill_tpu.tokenizer import bytes_to_unicode

    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for ch in bytes_to_unicode().values():
        vocab[ch] = len(vocab)
    merges = ["Ġ t", "h e", "Ġt he", "i n", "Ġ in", "a t", "Ġ a"]
    for m in merges:
        vocab["".join(m.split())] = len(vocab)
    return vocab, merges


TEXTS = ["Hello [IMG0] world\n", "the cat in the hat at a table",
         "  spaces\tand\nnewlines  ", "héllo wörld ✓ 123 4.5",
         "[IMG1][IMG2]<|image|> it's they'll"]


@pytest.mark.parametrize("kind", ["tiny", "bpe"])
def test_tokenizer_matches_gill_tpu(kind):
    from gill_tpu import tokenizer as jtok
    from gill_tpu_torch import tokenizer as ttok

    if kind == "tiny":
        a, b = jtok.GPT2BPETokenizer.tiny(), ttok.GPT2BPETokenizer.tiny()
    else:
        vocab, merges = _bpe_vocab()
        a = jtok.GPT2BPETokenizer(vocab, merges)
        b = ttok.GPT2BPETokenizer(vocab, merges)
    assert jtok.setup_gill_tokenizer(a, 4) == ttok.setup_gill_tokenizer(b, 4)
    assert len(a) == len(b) and a.pad_token_id == b.pad_token_id
    for text in TEXTS:
        for special in (True, False):
            ids = a.encode(text, add_special_tokens=special)
            assert b.encode(text, add_special_tokens=special) == ids, text
            for skip in (True, False):
                assert b.decode(ids, skip_special_tokens=skip) == \
                    a.decode(ids, skip_special_tokens=skip)


@pytest.mark.parametrize("size", [(20, 20), (37, 64), (300, 150)])
def test_clip_preprocess_matches_gill_tpu(size):
    from gill_tpu.utils import image as jimg
    from gill_tpu_torch.utils import image as timg

    arr = np.random.RandomState(size[0]).randint(0, 256, size[::-1] + (3,),
                                                 dtype=np.uint8)
    img = Image.fromarray(arr)
    for image_size in (16, 224):
        np.testing.assert_array_equal(timg.clip_preprocess(img, image_size),
                                      jimg.clip_preprocess(img, image_size))
    for cap in ("a cat. on a mat", "\nline one\nline two", "no stop"):
        assert timg.truncate_caption(cap) == jimg.truncate_caption(cap)


def test_image_fetch_of_non_url_fails_at_once():
    from gill_tpu_torch.utils.image import get_image_from_url

    with pytest.raises(ValueError):
        get_image_from_url("cc3m/0000001.jpg")


def test_checkpoint_reader_matches_gill_tpu(tmp_path):
    from gill_tpu.utils import ckpt as jckpt
    from gill_tpu_torch.utils import ckpt as tckpt

    rng = np.random.RandomState(0)
    tree = {"adapters": {"a": rng.randn(3, 2).astype(np.float32),
                         "m": {"w": rng.randn(4).astype(np.float32)},
                         "l": [rng.randn(2), rng.randn(1)]}}
    jckpt.save_checkpoint(tree, str(tmp_path), step=3)
    got, meta = tckpt.load_checkpoint(str(tmp_path))
    want, jmeta = jckpt.load_checkpoint(str(tmp_path))
    assert meta == jmeta == {"step": 3}
    np.testing.assert_array_equal(got["adapters"]["a"], want["adapters"]["a"])
    np.testing.assert_array_equal(got["adapters"]["m"]["w"],
                                  want["adapters"]["m"]["w"])
    assert len(got["adapters"]["l"]) == 2

    np.savez(tmp_path / "decision.npz", w=rng.randn(16, 2), b=np.zeros(2))
    d1 = tckpt.load_decision_model(str(tmp_path / "decision.npz"))
    d2 = jckpt.load_reference_decision_model(str(tmp_path / "decision.npz"))
    np.testing.assert_array_equal(d1["w"], d2["w"])
