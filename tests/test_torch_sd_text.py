"""The SD text path and VAE encode of gill_tpu_torch against gill_tpu
(mirrors test_sd.py's text and encode cases): CLIPBPETokenizer ids and
masks equal (both truncation sides), `encode_text` within 1e-5,
`return_prompts_only`, the CFG unconditional embeddings equal to
gill_tpu's encoded "" (1e-5; before this port the pipeline always used
zeros), a tiny `prompt=` generation on shared latents within 1e-4 on [0, 1]
pixels, and `vae.encode`'s mean within 1e-5 relative to the output scale
(fp32 throughout; sums in another order).

The tiny weights come from the port's init and reach gill_tpu in its
layout through weights/from_jax.tree_to_numpy."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gill_tpu import tokenizer as jtok
from gill_tpu.models.sd import vae as jvae
from gill_tpu.models.sd.pipeline import StableDiffusionPipeline as JPipe
from gill_tpu.models.sd.pipeline import tiny_sd_config as jtiny
from gill_tpu_torch import tokenizer as ttok
from gill_tpu_torch.config import tiny_sd_config
from gill_tpu_torch.models import clip as tclip
from gill_tpu_torch.models.sd import unet as tunet
from gill_tpu_torch.models.sd import vae as tvae
from gill_tpu_torch.models.sd.pipeline import StableDiffusionPipeline
from gill_tpu_torch.nn.core import Init
from gill_tpu_torch.weights.from_jax import tree_to_numpy
from torch_threads import one_intra_op_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TEXTS = ["a dog", "A photo of a CAT,  sitting on a mat!", "", "  ",
         "héllo wörld 123 it's", "a " * 40]


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def _bpe_files(tmp_path):
    """A small CLIP vocab with merges, as diffusers' tokenizer/ holds it."""
    vocab = dict(jtok.CLIPBPETokenizer.tiny().encoder)
    merges = ["a </w>", "d o", "do g</w>", "c a", "ca t</w>", "t h", "th e</w>"]
    for m in merges:
        vocab["".join(m.split())] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges))
    return str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")


@pytest.mark.parametrize("kind", ["tiny", "files"])
def test_clip_tokenizer_matches_gill_tpu(tmp_path, kind):
    if kind == "tiny":
        a, b = jtok.CLIPBPETokenizer.tiny(), ttok.CLIPBPETokenizer.tiny()
    else:
        files = _bpe_files(tmp_path)
        a = jtok.CLIPBPETokenizer.from_files(*files)
        b = ttok.CLIPBPETokenizer.from_files(*files)
        assert len(b.bpe_ranks) == 7
    assert (a.bos_token_id, a.eos_token_id, a.pad_token_id) == \
        (b.bos_token_id, b.eos_token_id, b.pad_token_id)
    for text in TEXTS:
        assert b.encode(text) == a.encode(text), text
    for max_length in (None, 10):
        for side in ("right", "left"):
            ja = a(TEXTS, max_length=max_length, truncate_side=side)
            tb = b(TEXTS, max_length=max_length, truncate_side=side)
            for key in ("input_ids", "attention_mask"):
                assert tb[key].dtype == ja[key].dtype == np.int32
                np.testing.assert_array_equal(tb[key], ja[key])
    left = b("a " * 100, max_length=10, truncate_side="left").input_ids
    right = b("a " * 100, max_length=10, truncate_side="right").input_ids
    assert left.shape == right.shape == (1, 10)
    assert right[0, 0] == b.bos_token_id and right[0, -1] == b.eos_token_id


def test_gpt2_tokenizer_call_surface_matches_gill_tpu():
    a, b = jtok.GPT2BPETokenizer.tiny(), ttok.GPT2BPETokenizer.tiny()
    jtok.setup_gill_tokenizer(a, 4)
    ttok.setup_gill_tokenizer(b, 4)
    assert b.vocab_size == a.vocab_size and b.cls_token_id == a.cls_token_id
    texts = ["hello [IMG0] there", "a much longer line of text", "x"]
    for kw in ({}, {"padding": "max_length", "max_length": 40},
               {"truncation": True, "max_length": 4},
               {"padding": "max_length", "max_length": 40,
                "return_tensors": "np"}):
        for text in (texts, texts[0]):
            ja, tb = a(text, **kw), b(text, **kw)
            for key in ("input_ids", "attention_mask"):
                got, want = tb[key], ja[key]
                assert type(got) is type(want)
                if isinstance(want, np.ndarray):
                    assert got.dtype == want.dtype
                    got, want = got.tolist(), want.tolist()
                assert got == want
    ids = [a.encode(t) for t in texts]
    for skip in (True, False):
        assert b.batch_decode(ids, skip) == a.batch_decode(ids, skip)
    a.pad_token_id = b.pad_token_id = 2
    assert a.pad_token_id == b.pad_token_id == 2


@functools.lru_cache(maxsize=None)
def _pipes():
    """(gill_tpu pipeline, port pipeline) on the same tiny weights."""
    cfg = tiny_sd_config()
    init = Init(torch.Generator().manual_seed(0), "cpu")
    params = {"unet": tunet.init(init, cfg.unet),
              "vae_decoder": tvae.init_decoder(init, cfg.vae),
              "vae_encoder": tvae.init_encoder(init, cfg.vae),
              "text_encoder": tclip.init_text(init, cfg.text)}
    jparams = jax.tree_util.tree_map(jnp.asarray, tree_to_numpy(params))
    jp = JPipe(jtiny(), jparams, tokenizer=jtok.CLIPBPETokenizer.tiny())
    tp = StableDiffusionPipeline(cfg, params,
                                 tokenizer=ttok.CLIPBPETokenizer.tiny())
    return jp, tp


@pytest.mark.parametrize("side", ["right", "left"])
def test_encode_text_matches_gill_tpu(side):
    jp, tp = _pipes()
    prompts = ["a dog", "A photo of a CAT, sitting on a red mat by the door"]
    with torch.no_grad():
        got = tp.encode_text(prompts, truncate_side=side)
    assert tuple(got.shape) == (2, 16, 24)
    _close(got, jp.encode_text(prompts, truncate_side=side), 1e-5)


def test_return_prompts_only():
    jp, tp = _pipes()
    with torch.no_grad():
        got = tp(prompt="a cat", return_prompts_only=True)
        again = tp.encode_text(["a cat"])
    assert tuple(got.shape) == (1, tp.cfg.text.max_positions,
                                tp.cfg.text.hidden_size)
    assert torch.equal(got, again)
    _close(got, jp(prompt="a cat", return_prompts_only=True), 1e-5)
    with pytest.raises(ValueError):
        StableDiffusionPipeline(tp.cfg, {"unet": tp.params["unet"]})(
            prompt="a cat")


def test_uncond_embeds_encode_the_empty_prompt():
    """With a tokenizer and a text encoder loaded, CFG's unconditional
    embeddings are the encoded "" (gill_tpu's `_uncond_embeds`), not the
    zeros of a pipeline without them."""
    jp, tp = _pipes()
    with torch.no_grad():
        got = tp._uncond_embeds(2)
    want = np.asarray(jp._uncond_embeds(2))
    assert tuple(got.shape) == want.shape == (2, 16, 24)
    _close(got, want, 1e-5)
    assert float(np.abs(want).max()) > 0.1
    bare = StableDiffusionPipeline(tp.cfg, {"unet": tp.params["unet"],
                                            "vae_decoder": tp.params[
                                                "vae_decoder"]})
    zeros = bare._uncond_embeds(2)
    assert zeros.dtype == torch.float32 and not bool(zeros.any())


def test_prompt_generation_matches_gill_tpu():
    """A tiny `prompt=` generation (3 PNDM steps, CFG 7.5) on shared
    latents: images within 1e-4 on [0, 1] pixels."""
    jp, tp = _pipes()
    lat = np.random.RandomState(4).randn(1, 8, 8, 4).astype(np.float32)
    kw = dict(num_inference_steps=3, guidance_scale=7.5)
    want = jp(prompt="a dog on a mat", latents=jnp.asarray(lat), **kw)
    with torch.no_grad():
        got = tp(prompt="a dog on a mat", latents=torch.from_numpy(lat), **kw)
    assert tuple(got.shape) == (1, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_vae_encode_matches_gill_tpu():
    jp, tp = _pipes()
    cfg = tp.cfg
    img = np.random.RandomState(5).uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32)
    enc = tp.params["vae_encoder"]
    with torch.no_grad():
        got = tvae.encode(enc, cfg.vae, torch.from_numpy(img))
        assert tuple(got.shape) == (2, 8, 8, 4)
        _close(got, jvae.encode(jp.params["vae_encoder"], jtiny().vae,
                                jnp.asarray(img)), 1e-5)
        # sample=True: the mean plus the posterior's deviation times
        # noise drawn from the generator
        sample = tvae.encode(enc, cfg.vae, torch.from_numpy(img),
                             generator=torch.Generator().manual_seed(9),
                             sample=True)
        noise = torch.randn((2, 8, 8, 4),
                            generator=torch.Generator().manual_seed(9))
        mean, logvar = tvae.encode_moments(enc, cfg.vae,
                                           torch.from_numpy(img))
        want = (mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * noise) \
            * tvae.SCALING_FACTOR
    torch.testing.assert_close(sample, want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tvae.encode(enc, cfg.vae, torch.from_numpy(img), sample=True)

