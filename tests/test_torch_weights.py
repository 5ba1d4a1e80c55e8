"""gill_tpu_torch/weights (loader.py, convert.py) against gill_tpu/weights.

The safetensors reader on files of the `safetensors` package and of
chip_smoke.py's pure-Python writer (BF16, F16, F32, I64, ...), the
directory loader over shards and `.bin` files, and every converter on the
same state dicts (random `transformers` OPT / CLIP models built from
config objects, the diffusers-named torch replicas of
tests/test_sd_full_torch.py, hand-built VAE-encoder and safety-checker
dicts): each tree equal to gill_tpu's converter's, leaf for leaf
(np.array_equal). chip_smoke.py's inverse maps (tree -> HF / diffusers
names), which phase G writes its weights directory with, are held to the
state dicts they invert.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from gill_tpu.weights import convert as jconv
from gill_tpu.weights import loader as jload
from gill_tpu_torch.weights import convert as tconv
from gill_tpu_torch.weights import loader as tload
from gill_tpu_torch.weights.from_jax import tree_from_jax, tree_to_numpy
from torch_threads import one_intra_op_thread  # noqa: F401

transformers = pytest.importorskip("transformers")


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_np(v) for v in tree]
    if torch.is_tensor(tree):
        t = tree.detach()
        return (t.float() if t.is_floating_point() else t).numpy()
    return np.asarray(tree)


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(got), sorted(want))
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_tree_equal(a, b, f"{path}/{i}")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and np.array_equal(g, w), path


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"bf16": torch.randn(3, 5, generator=g).bfloat16(),
            "f16": torch.randn(4, generator=g).half(),
            "f32": torch.randn(2, 3, 2, generator=g),
            "i64": torch.arange(-3, 9, dtype=torch.int64).reshape(3, 4),
            "scalar": torch.tensor(2.5)}


@pytest.mark.parametrize("writer", ["safetensors", "chip_smoke"])
def test_read_safetensors_matches_gill_tpu(tmp_path, writer):
    tensors = _tensors()
    path = str(tmp_path / "w.safetensors")
    if writer == "safetensors":
        st = pytest.importorskip("safetensors.torch")
        st.save_file(tensors, path)
    else:
        tensors.update(i32=torch.tensor([1, -2], dtype=torch.int32),
                       u8=torch.tensor([0, 255], dtype=torch.uint8),
                       flag=torch.tensor([True, False]),
                       empty=torch.zeros(0, 3))
        chip_smoke.write_safetensors(path, tensors)
    got = tload.read_safetensors(path, device="cpu")
    want = jload.read_safetensors(path)
    assert set(got) == set(want) == set(tensors)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert got[k].numpy().dtype == w.dtype, k        # BF16 upcast
        np.testing.assert_array_equal(got[k].numpy(), w)
        np.testing.assert_array_equal(
            got[k].numpy(), tensors[k].float().numpy() if k == "bf16"
            else tensors[k].numpy())
    # in a dtype: each floating tensor cast once from the file's, the
    # others as written (bf16 into bf16 bit for bit)
    dev = tload.read_safetensors(path, device="cpu", dtype=torch.bfloat16)
    for k, t in tensors.items():
        want_t = t.bfloat16() if t.is_floating_point() else t
        assert dev[k].dtype == want_t.dtype and torch.equal(dev[k], want_t), k


@pytest.mark.parametrize("kind", ["shards", "bin", "bin_legacy"])
def test_load_state_dict_dir_matches_gill_tpu(tmp_path, kind):
    g = torch.Generator().manual_seed(1)
    parts = [{"a.weight": torch.randn(4, 3, generator=g),
              "a.bias": torch.randn(4, generator=g).bfloat16()},
             {"b.weight": torch.randn(2, 2, generator=g).half(),
              "b.ids": torch.arange(5)}]
    for i, part in enumerate(parts):
        if kind == "shards":
            chip_smoke.write_safetensors(
                str(tmp_path / f"model-0000{i + 1}.safetensors"), part)
        else:
            torch.save(part, str(tmp_path / f"pytorch_model-0000{i + 1}.bin"),
                       _use_new_zipfile_serialization=kind == "bin")
    got = tload.load_state_dict_dir(str(tmp_path), device="cpu")
    want = jload.load_state_dict_dir(str(tmp_path))
    _assert_tree_equal(_to_np(got), want)
    dev = tload.load_state_dict_dir(str(tmp_path), device="cpu",
                                    dtype=torch.bfloat16)
    for part in parts:
        for k, t in part.items():
            want_t = t.bfloat16() if t.is_floating_point() else t
            assert dev[k].dtype == want_t.dtype and torch.equal(dev[k], want_t)
    with pytest.raises(FileNotFoundError):
        tload.load_state_dict_dir(str(tmp_path / "nowhere"), device="cpu")


def test_model_dir_search_rules(tmp_path, monkeypatch):
    root, env = tmp_path / "root", tmp_path / "env"
    for d in (root / "org--model", env / "other"):
        d.mkdir(parents=True)
        chip_smoke.write_safetensors(str(d / "m.safetensors"),
                                     {"x": torch.zeros(1)})
    monkeypatch.setenv("GILL_TPU_WEIGHTS_DIR", str(env))
    for name, r in (("org/model", str(root)), ("x/other", None),
                    ("x/other", str(root)), ("x/missing", str(root)),
                    ("x/missing", None)):
        assert tload._model_dir(name, r) == jload._model_dir(name, r)
    assert tload._model_dir("org/model", str(root)) == str(root / "org--model")
    assert tload._model_dir("x/other", None) == str(env / "other")


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------

def _opt(post_ln: bool):
    from gill_tpu.config import OPTConfig

    cfg = OPTConfig(hidden_size=16, ffn_dim=32, num_layers=2, num_heads=2,
                    word_embed_proj_dim=8 if post_ln else 16, vocab_size=50,
                    max_positions=24, do_layer_norm_before=not post_ln)
    hf = transformers.OPTConfig(
        vocab_size=50, hidden_size=16, num_hidden_layers=2, ffn_dim=32,
        num_attention_heads=2, max_position_embeddings=24,
        word_embed_proj_dim=cfg.word_embed_proj_dim,
        do_layer_norm_before=cfg.do_layer_norm_before)
    torch.manual_seed(0)
    sd = transformers.OPTForCausalLM(hf).state_dict()
    return sd, cfg


def _clip_vision_cfgs():
    from gill_tpu.config import CLIPVisionConfig

    vis = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_layers=2,
                           num_heads=4, image_size=32, patch_size=8)
    hf = transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, image_size=32, patch_size=8,
        hidden_act="quick_gelu", projection_dim=16)
    return vis, hf


def _clip_text():
    from gill_tpu.models.clip import CLIPTextConfig

    cfg = CLIPTextConfig(vocab_size=100, hidden_size=32, intermediate_size=64,
                         num_layers=2, num_heads=4, max_positions=16,
                         eos_token_id=99)
    hf = transformers.CLIPTextConfig(
        vocab_size=100, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=16, hidden_act="quick_gelu",
        eos_token_id=99, bos_token_id=98)
    torch.manual_seed(1)
    return transformers.CLIPTextModel(hf).state_dict(), cfg


def _safety():
    from test_safety import CFG, _fake_diffusers_sd

    return _fake_diffusers_sd(seed=2)[1], CFG


def _vae_cfg():
    from gill_tpu.models.sd.vae import VAEConfig

    return VAEConfig(block_out_channels=(8, 16, 24), layers_per_block=1,
                     norm_groups=4)


def _vae_encoder_sd(cfg):
    """A diffusers-named encoder dict from a random port encoder tree."""
    from gill_tpu_torch.models.sd import vae as tvae
    from gill_tpu_torch.nn.core import Init

    enc = tvae.init_encoder(Init(torch.Generator().manual_seed(4), "cpu"),
                            cfg)
    return enc, {k: v for k, v in chip_smoke.vae_to_diffusers(
        tvae.init_decoder(Init(torch.Generator().manual_seed(5), "cpu"), cfg),
        enc).items() if not k.startswith(("decoder.", "post_quant"))}


def _old_vae_keys(sd):
    """diffusers' old VAE attention spelling, 1x1-conv q/k/v/o weights."""
    ren = {"group_norm": "norm", "to_q": "query", "to_k": "key",
           "to_v": "value", "to_out.0": "proj_attn"}
    out = {}
    for k, v in sd.items():
        if ".attentions." in k:
            for a, b in ren.items():
                k = k.replace(f".{a}.", f".{b}.")
            if v.ndim == 2:
                v = v[:, :, None, None]
        out[k] = v
    return out


def _case(name):
    """(state dict, gill_tpu converter, port converter, args)."""
    if name in ("opt", "opt_post_ln"):
        sd, cfg = _opt(name == "opt_post_ln")
        return sd, jconv.opt_from_torch, tconv.opt_from_torch, (cfg,)
    if name in ("clip_vision", "clip_vision_projection"):
        vis, hf = _clip_vision_cfgs()
        torch.manual_seed(3)
        model = (transformers.CLIPVisionModelWithProjection
                 if name == "clip_vision_projection"
                 else transformers.CLIPVisionModel)(hf)
        return (model.state_dict(), jconv.clip_vision_from_torch,
                tconv.clip_vision_from_torch, (vis,))
    if name == "clip_text":
        sd, cfg = _clip_text()
        return sd, jconv.clip_text_from_torch, tconv.clip_text_from_torch, \
            (cfg,)
    if name == "safety":
        sd, cfg = _safety()
        return sd, jconv.safety_checker_from_torch, \
            tconv.safety_checker_from_torch, (cfg,)
    if name in ("mapper_linear", "mapper_gill"):
        from test_mapper import TorchTextFc

        torch.manual_seed(6)
        mode = name.split("_")[1].replace("gill", "gill_mapper")
        m = TorchTextFc(24, 16, 3, mode, hidden=32, nhead=4, ff=64, n_enc=2,
                        n_dec=2)
        sd = {"pre." + k: v for k, v in m.state_dict().items()}
        return sd, jconv.text_fc_layer_from_torch, \
            tconv.text_fc_layer_from_torch, ("pre.", mode, 32, 2, 2)
    if name == "unet":
        from gill_tpu.models.sd import unet as junet
        from test_sd_full_torch import TorchUNet

        torch.manual_seed(7)
        cfg = junet.tiny_unet_config()
        return TorchUNet(cfg).state_dict_diffusers(), \
            jconv.sd_unet_from_torch, tconv.sd_unet_from_torch, (cfg,)
    if name in ("vae_decoder", "vae_decoder_old_keys"):
        from test_sd_full_torch import TorchVAEDecoder

        torch.manual_seed(8)
        cfg = _vae_cfg()
        sd = {k: v.detach() for k, v in TorchVAEDecoder(cfg).state_dict()
              .items()}
        if name == "vae_decoder_old_keys":
            sd = _old_vae_keys(sd)
        return sd, jconv.sd_vae_decoder_from_torch, \
            tconv.sd_vae_decoder_from_torch, (cfg,)
    if name in ("vae_encoder", "vae_encoder_old_keys"):
        cfg = _vae_cfg()
        sd = _vae_encoder_sd(cfg)[1]
        if name == "vae_encoder_old_keys":
            sd = _old_vae_keys(sd)
        return sd, jconv.sd_vae_encoder_from_torch, \
            tconv.sd_vae_encoder_from_torch, (cfg,)
    raise KeyError(name)


CASES = ["opt", "opt_post_ln", "clip_vision", "clip_vision_projection",
         "clip_text", "safety", "mapper_linear", "mapper_gill", "unet",
         "vae_decoder", "vae_decoder_old_keys", "vae_encoder",
         "vae_encoder_old_keys"]


@pytest.mark.parametrize("name", CASES)
def test_converter_matches_gill_tpu(name):
    """Each converter's tree (views and stacks of the state dict's
    tensors) equals gill_tpu's, leaf for leaf."""
    sd, jfn, tfn, args = _case(name)
    want = jfn(sd, *args)
    _assert_tree_equal(_to_np(tfn(sd, *args)), want)


INVERSES = {
    "opt": lambda t, sd: chip_smoke.opt_to_hf(
        t, t["layers"]["fc1"]["w"].shape[0],
        t["embed_tokens"]["weight"].shape[0]),
    "clip_vision_projection": lambda t, sd: chip_smoke.clip_vision_to_hf(t),
    "clip_text": lambda t, sd: chip_smoke.clip_text_to_hf(t),
    "safety": lambda t, sd: chip_smoke.safety_to_diffusers(t),
    "unet": lambda t, sd: chip_smoke.unet_to_diffusers(t),
    "vae_decoder": lambda t, sd: chip_smoke.vae_to_diffusers(t),
}


@pytest.mark.parametrize("name", sorted(INVERSES))
def test_chip_smoke_inverse_maps(name):
    """chip_smoke's tree -> HF / diffusers maps give back the state dict
    the port's converter read, key for key and bit for bit (buffers such
    as position_ids aside), through the device layout of tree_from_jax."""
    sd, _, tfn, args = _case(name)
    tree = tree_from_jax(tfn(sd, *args))
    back = INVERSES[name](tree, sd)
    want = {k: v for k, v in sd.items() if not k.endswith("position_ids")}
    assert set(back) == set(want), sorted(set(back) ^ set(want))
    for k, v in want.items():
        assert torch.equal(back[k].float(), v.float()), k


def test_vae_encoder_round_trip():
    """A port encoder tree -> diffusers names -> the port's converter ->
    tree_from_jax is the same tree, bit for bit and in the same layout."""
    enc, sd = _vae_encoder_sd(_vae_cfg())
    got = tree_from_jax(tconv.sd_vae_encoder_from_torch(sd, _vae_cfg()))
    _assert_tree_equal(tree_to_numpy(got), tree_to_numpy(enc))
    conv = got["down"][0]["resnets"][0]["conv1"]["w"]
    assert conv.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("which", ["unet", "vae_decoder"])
def test_stray_key_is_refused(which):
    """The strict consumed-key check: a key the converter does not read
    fails in both packages."""
    sd, jfn, tfn, args = _case(which)
    sd = dict(sd)
    stray = ("down_blocks.0.extra.weight" if which == "unet"
             else "decoder.extra.weight")
    sd[stray] = torch.zeros(1)
    for fn in (jfn, tfn):
        with pytest.raises(AssertionError, match="extra"):
            fn(sd, *args)
