"""`load_gill(weights_dir=)` of gill_tpu_torch against gill_tpu's on one
tiny weights directory (GILL_TPU_TINY_SD=1): OPT from an HF
`pytorch_model.bin`, CLIP ViT with its projection from a safetensors file,
SD v1.5 in the diffusers layout (unet/, vae/ with an encoder,
text_encoder/, tokenizer/, safety_checker/) and the reference's
`pretrained_ckpt.pth.tar` adapters, the files written by chip_smoke.py's
writers from trees of the port's init and random `transformers` models.

  * every loaded tree equal to gill_tpu's (tree_to_numpy), apart from the
    [IMG] rows the loaders add to the embedding table (a torch.Generator
    here, threefry there), which both sides are then given through
    from_jax; GILL_TPU_WEIGHTS_DIR finds the same directory;
  * text-route tokens and captions equal; the [IMG] route, whose CFG now
    takes the encoded "" as its unconditional embedding in both, gives the
    same caption and its image within 1e-4 on [0, 1] pixels on shared
    latents;
  * `get_log_likelihood_scores` within 1e-5 relative; `opt.loss_fn` and
    `clip.get_image_features` within 1e-5; `save_embeddings` ->
    `load_embeddings` round trip;
  * `weights.loader.load_sd`'s directory search (weights_root, the
    environment, none).
"""

import contextlib
import io
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from gill_tpu_torch.weights.from_jax import tree_to_numpy
from torch_threads import one_intra_op_thread  # noqa: F401

transformers = pytest.importorskip("transformers")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OPT_VOCAB = 262          # < len(tokenizer) = 265: load_opt adds 3 rows
STEPS = 3


def _port_core(cfg):
    from gill_tpu_torch.models.gill import GILLCore
    from gill_tpu_torch.tokenizer import GPT2BPETokenizer, setup_gill_tokenizer

    tok = GPT2BPETokenizer.tiny()
    ids = setup_gill_tokenizer(tok, cfg.num_tokens)
    return GILLCore.build(cfg, vocab_len=len(tok), img_start=ids[0],
                          pad_token_id=tok.pad_token_id,
                          bos_token_id=tok.bos_token_id)


def _write_dirs(root):
    from gill_tpu_torch.config import GILLConfig, tiny_sd_config
    from gill_tpu_torch.models import clip as tclip
    from gill_tpu_torch.models import safety as tsafety
    from gill_tpu_torch.models.sd import unet as tunet
    from gill_tpu_torch.models.sd import vae as tvae
    from gill_tpu_torch.nn.core import Init
    from gill_tpu_torch.retrieval import save_embeddings
    from gill_tpu_torch.tokenizer import CLIPBPETokenizer

    mdir, wdir = root / "model", root / "weights"
    sd_dir = wdir / "stable-diffusion-v1-5"
    for d in (mdir, wdir / "opt-tiny", wdir / "test--clip-tiny",
              *(sd_dir / s for s in ("unet", "vae", "text_encoder",
                                     "tokenizer", "safety_checker"))):
        d.mkdir(parents=True)
    cfg = GILLConfig(opt_version="test/opt-tiny",
                     visual_encoder="test/clip-tiny", n_visual_tokens=2,
                     num_tokens=4, num_clip_tokens=6, ret_emb_dim=8,
                     gen_emb_dim=24, image_size=16)
    cfg.to_json(str(mdir / "model_args.json"))

    torch.manual_seed(0)
    opt = transformers.OPTForCausalLM(transformers.OPTConfig(
        vocab_size=OPT_VOCAB, hidden_size=16, num_hidden_layers=2, ffn_dim=32,
        num_attention_heads=2, max_position_embeddings=96,
        word_embed_proj_dim=16, do_layer_norm_before=True))
    torch.save(opt.state_dict(), str(wdir / "opt-tiny" / "pytorch_model.bin"))
    clip = transformers.CLIPVisionModelWithProjection(
        transformers.CLIPVisionConfig(
            hidden_size=16, intermediate_size=32, num_hidden_layers=1,
            num_attention_heads=2, image_size=16, patch_size=8,
            hidden_act="quick_gelu", projection_dim=8))
    chip_smoke.write_safetensors(
        str(wdir / "test--clip-tiny" / "model.safetensors"),
        {k: v.detach() for k, v in clip.state_dict().items()})

    sd_cfg = tiny_sd_config()
    init = Init(torch.Generator().manual_seed(1), "cpu")
    st = {"unet": chip_smoke.unet_to_diffusers(tunet.init(init, sd_cfg.unet)),
          "vae": chip_smoke.vae_to_diffusers(
              tvae.init_decoder(init, sd_cfg.vae),
              tvae.init_encoder(init, sd_cfg.vae)),
          "text_encoder": chip_smoke.clip_text_to_hf(
              tclip.init_text(init, sd_cfg.text)),
          "safety_checker": chip_smoke.safety_to_diffusers(
              tsafety.init(init, tsafety.tiny_safety_config()))}
    for sub, sd in st.items():
        chip_smoke.write_safetensors(str(sd_dir / sub / "model.safetensors"),
                                     sd)
    tok = CLIPBPETokenizer.tiny()
    (sd_dir / "tokenizer" / "vocab.json").write_text(json.dumps(tok.encoder))
    (sd_dir / "tokenizer" / "merges.txt").write_text("#version: 0.2\n")

    core = _port_core(cfg)
    adapters = core.init_adapters(Init(torch.Generator().manual_seed(2),
                                       "cpu"))
    table = torch.randn(core.vocab_len, core.lm_dim)
    table[-cfg.num_tokens:] = adapters["img_embeddings"]
    torch.save({"state_dict": chip_smoke.adapters_to_reference(
        adapters, core, table)}, str(mdir / "pretrained_ckpt.pth.tar"))
    rng = np.random.RandomState(0)
    save_embeddings(str(mdir / "cc3m_embeddings.npy"),
                    [f"p{i}" for i in range(6)],
                    torch.from_numpy(rng.randn(6, 8).astype(np.float32)))
    np.savez(mdir / "decision_model.npz",
             w=rng.randn(16, 2).astype(np.float32), b=np.zeros(2, np.float32))
    return mdir, wdir


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    from gill_tpu.api import load_gill as jload_gill
    from gill_tpu_torch.api import load_gill as tload_gill

    mdir, wdir = _write_dirs(tmp_path_factory.mktemp("w"))
    old = os.environ.get("GILL_TPU_TINY_SD")
    os.environ["GILL_TPU_TINY_SD"] = "1"
    out = io.StringIO()
    try:
        jm = jload_gill(str(mdir), weights_dir=str(wdir),
                        decision_model_fn="decision_model.npz",
                        dtype=jnp.float32)
        with contextlib.redirect_stdout(out):
            tm = tload_gill(str(mdir), device="cpu", weights_dir=str(wdir),
                            decision_model_fn="decision_model.npz",
                            dtype=torch.float32)
    finally:
        if old is None:
            del os.environ["GILL_TPU_TINY_SD"]
        else:
            os.environ["GILL_TPU_TINY_SD"] = old
    return jm, tm, mdir, wdir, out.getvalue()


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_tree_equal(a, b, f"{path}/{i}")
    else:
        g, w = np.asarray(got), np.asarray(want)
        if w.ndim == 0 and g.shape == (1,):    # tree_to_numpy's 0-d leaves
            g = g.reshape(())
        assert g.shape == w.shape and np.array_equal(g, w), path


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _sync_img_rows(jm, tm):
    """The rows load_opt grew the table by: gill_tpu's, in the port."""
    w = tm.params["lm"]["embed_tokens"]["weight"]
    w[OPT_VOCAB:] = torch.from_numpy(np.asarray(
        jm.params["lm"]["embed_tokens"]["weight"])[OPT_VOCAB:])


def test_loaded_trees_match_gill_tpu(loaded):
    from gill_tpu.weights.convert import sd_vae_encoder_from_torch
    from gill_tpu.weights.loader import load_state_dict_dir

    jm, tm, _, wdir, out = loaded
    assert "not ported yet" not in out
    jp, tp = _np(jm.params), tree_to_numpy(tm.params)
    jlm, tlm = dict(jp["lm"]), dict(tp["lm"])
    jtab = jlm.pop("embed_tokens")["weight"]
    ttab = tlm.pop("embed_tokens")["weight"]
    assert ttab.shape == jtab.shape == (265, 16)
    np.testing.assert_array_equal(ttab[:OPT_VOCAB], jtab[:OPT_VOCAB])
    assert not np.array_equal(ttab[OPT_VOCAB:], jtab[OPT_VOCAB:])
    _assert_tree_equal(tlm, jlm)
    assert "visual_projection" in tp["vision"]
    _assert_tree_equal(tp["vision"], jp["vision"])
    _assert_tree_equal(tp["adapters"], jp["adapters"])
    jsd, tsd = _np(jm.sd_pipe.params), tree_to_numpy(tm.sd_pipe.params)
    assert set(tsd) == set(jsd) | {"vae_encoder"}
    for k in jsd:
        _assert_tree_equal(tsd[k], jsd[k], k)
    cfg = tm.sd_pipe.cfg
    _assert_tree_equal(tsd["vae_encoder"], sd_vae_encoder_from_torch(
        load_state_dict_dir(str(wdir / "stable-diffusion-v1-5" / "vae")),
        cfg.vae))
    # the SD tokenizer loads; the tiny checker does not fit ViT-L/14's
    # config, so both packages warn and run without it
    assert tm.sd_pipe.tokenizer is not None and jm.sd_pipe.tokenizer is not None
    assert tm.sd_pipe.safety_checker is None is jm.sd_pipe.safety_checker
    assert "safety checker failed to load" in out
    assert tm.index.paths == jm.index.paths


def test_weights_dir_from_the_environment(loaded, monkeypatch):
    from gill_tpu_torch.api import load_gill

    _, tm, mdir, wdir, _ = loaded
    monkeypatch.setenv("GILL_TPU_WEIGHTS_DIR", str(wdir))
    monkeypatch.setenv("GILL_TPU_TINY_SD", "1")
    again = load_gill(str(mdir), device="cpu", load_ret_embs=False,
                      decision_model_fn=None, dtype=torch.float32)
    want = tree_to_numpy(tm.params)
    got = tree_to_numpy(again.params)
    _assert_tree_equal(got["vision"], want["vision"])
    _assert_tree_equal(got["adapters"], want["adapters"])
    np.testing.assert_array_equal(
        got["lm"]["embed_tokens"]["weight"][:OPT_VOCAB],
        want["lm"]["embed_tokens"]["weight"][:OPT_VOCAB])
    _assert_tree_equal(tree_to_numpy(again.sd_pipe.params),
                       tree_to_numpy(tm.sd_pipe.params))


def test_reference_ckpt_takes_precedence_over_npz(loaded, tmp_path):
    """pretrained_ckpt.pth.tar, then ckpt/state.npz, then random (gill_tpu's
    order)."""
    import shutil

    from gill_tpu.utils.ckpt import save_checkpoint
    from gill_tpu_torch.api import load_gill

    _, tm, mdir, wdir, _ = loaded
    d = tmp_path / "m"
    shutil.copytree(mdir, d)
    save_checkpoint({"adapters": {"logit_scale": np.float32(9.0)}}, str(d),
                    step=1)
    kw = dict(device="cpu", weights_dir=str(wdir), load_sd=False,
              load_ret_embs=False, decision_model_fn=None,
              dtype=torch.float32)
    m = load_gill(str(d), **kw)
    assert float(m.params["adapters"]["logit_scale"]) == \
        float(tm.params["adapters"]["logit_scale"]) != 9.0
    os.remove(d / "pretrained_ckpt.pth.tar")
    assert float(load_gill(str(d), **kw).params["adapters"][
        "logit_scale"]) == 9.0


def _image():
    return Image.fromarray(np.random.RandomState(3).randint(
        0, 256, (20, 24, 3), dtype=np.uint8))


@pytest.mark.parametrize("prompt_kind", ["image_question", "text_only"])
def test_text_route_tokens_equal(loaded, prompt_kind):
    jm, tm, _, _, _ = loaded
    _sync_img_rows(jm, tm)
    prompts = ([_image(), "Q: hi\nA:"] if prompt_kind == "image_question"
               else ["A picture of"])
    kw = dict(num_words=8, min_word_tokens=8)
    with torch.no_grad():
        got = tm.generate_for_images_and_texts(prompts, **kw)
    assert got == jm.generate_for_images_and_texts(prompts, **kw)


class _SharedLatents:
    """Calls the pipeline with fixed latents and records its images."""

    def __init__(self, pipe, lat):
        self.pipe, self.lat, self.images = pipe, lat, []
        self.cfg = pipe.cfg

    def __call__(self, **kw):
        kw.pop("rng", None)
        kw.pop("generator", None)
        img = self.pipe(latents=self.lat, **kw)
        self.images.append(np.asarray(img))
        return img


def test_img_route_image_matches_gill_tpu(loaded):
    jm, tm, _, _, _ = loaded
    _sync_img_rows(jm, tm)
    lat = np.random.RandomState(7).randn(1, 8, 8, 4).astype(np.float32)
    jpipe, tpipe = jm.sd_pipe, tm.sd_pipe
    jm.sd_pipe = _SharedLatents(jpipe, jnp.asarray(lat))
    tm.sd_pipe = _SharedLatents(tpipe, torch.from_numpy(lat))
    try:
        kw = dict(num_words=6, gen_scale_factor=1e6,
                  num_inference_steps=STEPS)
        want = jm.generate_for_images_and_texts(["A picture of"], **kw)
        with torch.no_grad():
            got = tm.generate_for_images_and_texts(["A picture of"], **kw)
        timgs, jimgs = tm.sd_pipe.images, jm.sd_pipe.images
    finally:
        jm.sd_pipe, tm.sd_pipe = jpipe, tpipe
    assert got[0] == want[0] and len(got) == len(want) == 2
    assert got[1]["decision"][0] == want[1]["decision"][0]
    assert len(timgs) == len(jimgs) == 1
    np.testing.assert_allclose(timgs[0], jimgs[0], rtol=0, atol=1e-4)


def test_log_likelihood_scores_match(loaded):
    jm, tm, _, _, _ = loaded
    _sync_img_rows(jm, tm)
    prompts = [_image(), "A red canoe near the shore of a lake."]
    with torch.no_grad():
        got = tm.get_log_likelihood_scores(prompts)
    want = jm.get_log_likelihood_scores(prompts)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_loss_fn_matches_gill_tpu():
    from gill_tpu.models import opt as jopt
    from gill_tpu_torch.models import opt as topt

    rng = np.random.RandomState(0)
    logits = rng.randn(2, 7, 11).astype(np.float32) * 3
    labels = rng.randint(0, 11, (2, 7)).astype(np.int32)
    labels[0, 2:4] = -100
    labels[1, 5] = -100
    for ignore in (-100, 3):
        lab = np.where(labels == -100, ignore, labels).astype(np.int32)
        got = topt.loss_fn(torch.from_numpy(logits), torch.from_numpy(lab),
                           ignore_index=ignore)
        want = jopt.loss_fn(jnp.asarray(logits), jnp.asarray(lab),
                            ignore_index=ignore)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    all_ignored = np.full((1, 4), -100, np.int32)
    assert float(topt.loss_fn(torch.from_numpy(logits[:1, :4]),
                              torch.from_numpy(all_ignored))) == 0.0


def test_image_features_match(loaded):
    from gill_tpu.models import clip as jclip
    from gill_tpu_torch.models import clip as tclip

    jm, tm, _, _, _ = loaded
    px = np.random.RandomState(1).randn(2, 16, 16, 3).astype(np.float32)
    with torch.no_grad():
        got = tclip.get_image_features(tm.params["vision"], tm.core.vis_cfg,
                                       torch.from_numpy(px))
    want = jclip.get_image_features(jm.params["vision"], jm.core.vis_cfg,
                                    jnp.asarray(px))
    assert tuple(got.shape) == (2, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(KeyError):
        vision = {k: v for k, v in tm.params["vision"].items()
                  if k != "visual_projection"}
        tclip.get_image_features(vision, tm.core.vis_cfg,
                                 torch.from_numpy(px))


@pytest.mark.parametrize("where", ["weights_dir", "environment", "missing"])
def test_load_sd_finds_the_diffusers_directory(loaded, tmp_path, monkeypatch,
                                               where):
    """weights.loader.load_sd: `<root>/stable-diffusion-v1-5/` from
    `weights_root` or GILL_TPU_WEIGHTS_DIR gives load_gill's SD trees and
    tokenizer (the tiny checker does not fit ViT-L/14: warned, left out);
    a root with no directory holding unet/ gives random trees, no
    tokenizer and no checker, with gill_tpu's warning."""
    from gill_tpu_torch.weights.loader import load_sd

    _, tm, _, wdir, _ = loaded
    root = str(wdir)
    if where == "environment":
        monkeypatch.setenv("GILL_TPU_WEIGHTS_DIR", root)
        root = None
    elif where == "missing":
        (tmp_path / "stable-diffusion-v1-5" / "vae").mkdir(parents=True)
        monkeypatch.delenv("GILL_TPU_WEIGHTS_DIR", raising=False)
        root = str(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        params, tok, checker = load_sd(
            "stable-diffusion-v1-5", tm.sd_pipe.cfg, root, device="cpu",
            dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    assert checker is None
    if where == "missing":
        assert tok is None and "no local SD weights" in out.getvalue()
        assert set(params) == {"unet", "vae_decoder", "text_encoder"}
        return
    assert tok is not None and tok.encoder == tm.sd_pipe.tokenizer.encoder
    assert "safety checker failed to load" in out.getvalue()
    _assert_tree_equal(tree_to_numpy(params),
                       tree_to_numpy(tm.sd_pipe.params))


def test_save_embeddings_round_trip(loaded, tmp_path):
    from gill_tpu.retrieval import load_embeddings as jload
    from gill_tpu_torch.retrieval import load_embeddings, save_embeddings

    _, _, mdir, _, _ = loaded
    paths, mat = load_embeddings(str(mdir))
    jpaths, jmat = jload(str(mdir))
    assert paths == jpaths == [f"p{i}" for i in range(6)]
    np.testing.assert_array_equal(mat, jmat)
    save_embeddings(str(tmp_path / "cc3m_a.npy"), paths[:2], mat[:2])
    save_embeddings(str(tmp_path / "cc3m_b.npy"), paths[2:],
                    torch.from_numpy(mat[2:]))
    with open(tmp_path / "cc3m_a.npy", "rb") as f:
        blob = pickle.load(f)
    assert set(blob) == {"paths", "embeddings"}
    p2, m2 = load_embeddings(str(tmp_path))
    assert p2 == paths
    np.testing.assert_array_equal(m2, mat)


def test_checker_loads_where_its_config_fits(loaded, monkeypatch):
    """With the checker's config set to the written one, load_gill loads
    it (gill_tpu's loader gives the same params) and the [IMG] route's
    image goes through it."""
    from gill_tpu.models import safety as jsafety
    from gill_tpu_torch.api import load_gill
    from gill_tpu_torch.models import safety as tsafety

    _, tm, mdir, wdir, _ = loaded
    tcfg, jcfg = tsafety.tiny_safety_config(), jsafety.tiny_safety_config()
    monkeypatch.setattr(tsafety, "SafetyCheckerConfig", lambda: tcfg)
    monkeypatch.setattr(jsafety, "SafetyCheckerConfig", lambda: jcfg)
    monkeypatch.setenv("GILL_TPU_TINY_SD", "1")
    m = load_gill(str(mdir), device="cpu", weights_dir=str(wdir),
                  load_ret_embs=False, decision_model_fn=None,
                  dtype=torch.float32)
    chk = m.sd_pipe.safety_checker
    assert chk is not None
    want = jsafety.load_safety_checker(
        str(wdir / "stable-diffusion-v1-5" / "safety_checker"),
        dtype=jnp.float32)
    _assert_tree_equal(tree_to_numpy(chk.params), _np(want.params))
    img = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    out, flags = chk(img)
    assert len(flags) == 2 and tuple(out.shape) == (2, 16, 16, 3)
    with torch.no_grad():
        emb = m.sd_pipe.encode_text(["a dog"])
        m.sd_pipe(prompt_embeds=emb, num_inference_steps=2,
                  generator=torch.Generator().manual_seed(0))
