"""The whole slice end to end: gill_tpu's and gill_tpu_torch's
`generate_for_images_and_texts` on the same tiny checkpoint directory (the
tests/test_load_gill.py fixture, GILL_TPU_TINY_SD=1), with gill_tpu's
parameters carried into the port by weights/from_jax.py.

The batch API (`generate_for_images_and_texts_batch`, bf16 and W8 LM
weights) runs through both packages' serving engines on the same prompts.
Greedy tokens and captions must be equal; the prompt embeddings, the
[IMG]-run hidden states, the decision probabilities and the GILLMapper
embedding agree to 1e-4 relative (fp32 through the LM and the adapters,
sums in another order); the SD images on shared latents (the two random
streams differ) to 1e-4 absolute on [0, 1] pixels.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gill_tpu_torch.weights.from_jax import gill_params_from_jax, tree_to_numpy
from torch_threads import one_intra_op_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

STEPS = 4     # denoise steps: PLMS warm-up, orders 1.5 to 3


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """The tiny checkpoint directory of tests/test_load_gill.py."""
    from gill_tpu.config import GILLConfig
    from gill_tpu.models.gill import GILLCore
    from gill_tpu.tokenizer import GPT2BPETokenizer, setup_gill_tokenizer
    from gill_tpu.utils.ckpt import save_checkpoint

    d = tmp_path_factory.mktemp("ckpt")
    cfg = GILLConfig(opt_version="test/opt-tiny",
                     visual_encoder="test/clip-tiny",
                     n_visual_tokens=2, num_tokens=4, num_clip_tokens=6,
                     ret_emb_dim=8, gen_emb_dim=12, image_size=16)
    cfg.to_json(str(d / "model_args.json"))
    tok = GPT2BPETokenizer.tiny()
    img_ids = setup_gill_tokenizer(tok, 4)
    core = GILLCore.build(cfg, vocab_len=len(tok), img_start=img_ids[0],
                          pad_token_id=tok.pad_token_id,
                          bos_token_id=tok.bos_token_id)
    save_checkpoint({"adapters": jax.device_get(
        core.init_adapters(jax.random.PRNGKey(7)))}, str(d), step=5)
    rng = np.random.RandomState(0)
    with open(d / "cc3m_embeddings.npy", "wb") as f:
        pickle.dump({"paths": [f"p{i}" for i in range(6)],
                     "embeddings": list(rng.randn(6, 8).astype(np.float32))},
                    f)
    np.savez(d / "decision_model.npz", w=rng.randn(16, 2).astype(np.float32),
             b=np.zeros(2, np.float32))
    return d


@pytest.fixture(scope="module")
def models(ckpt_dir):
    """Both packages' `load_gill` on the directory; the LM, CLIP and
    adapters carried from gill_tpu into the port, the tiny SD the other
    way: gill_tpu's pipeline is built as its load_gill builds it
    (GILL_TPU_TINY_SD=1), over the port's SD parameters (gill_tpu's eager
    UNet init costs ~20 s)."""
    from gill_tpu.api import load_gill as jload_gill
    from gill_tpu.models.sd.pipeline import StableDiffusionPipeline as JPipe
    from gill_tpu.models.sd.pipeline import tiny_sd_config
    from gill_tpu_torch.api import load_gill as tload_gill

    d = ckpt_dir
    old = os.environ.get("GILL_TPU_TINY_SD")
    os.environ["GILL_TPU_TINY_SD"] = "1"
    try:
        jm = jload_gill(str(d), decision_model_fn="decision_model.npz",
                        load_sd=False, dtype=jnp.float32)
        tm = tload_gill(str(d), device="cpu",
                        decision_model_fn="decision_model.npz", load_sd=True,
                        dtype=torch.float32)
    finally:
        if old is None:
            del os.environ["GILL_TPU_TINY_SD"]
        else:
            os.environ["GILL_TPU_TINY_SD"] = old
    tm.params = gill_params_from_jax(jax.device_get(jm.params))
    scfg = tiny_sd_config()
    scfg.unet.cross_attention_dim = jm.core.cfg.gen_emb_dim
    scfg.text.max_positions = jm.core.cfg.num_clip_tokens
    jm.sd_pipe = JPipe(scfg, jax.tree_util.tree_map(
        jnp.asarray, tree_to_numpy(tm.sd_pipe.params)))
    return jm, tm


def _close(got, want, rtol=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def _image():
    return Image.fromarray(np.random.RandomState(3).randint(
        0, 256, (20, 24, 3), dtype=np.uint8))


def test_loaded_state_matches(models):
    jm, tm = models
    assert tm.core.img_start == jm.core.img_start
    assert tm.core.vocab_len == jm.core.vocab_len
    assert tm.index.n == jm.index.n == 6 and tm.index.paths == jm.index.paths
    np.testing.assert_allclose(tm.index.matrix.numpy(),
                               np.asarray(jm.index.matrix), rtol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_array_equal(tm.decision_params[k].numpy(),
                                      np.asarray(jm.decision_params[k]))
    # the port read the same npz adapters the JAX loader did
    assert tm.params["adapters"]["img_embeddings"].dtype == torch.float32


def test_encode_and_generate_match(models):
    """Prompt embeddings, then the decode loop itself: tokens and valid
    mask equal, hidden states close, with a forced [IMG] run."""
    jm, tm = models
    prompts = [_image(), "Q: what?\nA:"]
    jembs, jids = jm._encode_prompts(prompts)
    tembs, tids = tm._encode_prompts(prompts)
    np.testing.assert_array_equal(tids, jids)
    _close(tembs, jembs, 1e-5)
    kw = dict(num_words=6, gen_scale_factor=1e6, max_img_runs=1)
    jout = jm._generate(jembs, **kw)
    tout = tm.core.generate(tm.params, tembs, **kw)
    np.testing.assert_array_equal(tout["tokens"].numpy(),
                                  np.asarray(jout["tokens"]))
    np.testing.assert_array_equal(tout["valid"].numpy(),
                                  np.asarray(jout["valid"]))
    valid = np.asarray(jout["valid"])[0]
    assert valid.sum() == 6 + 3      # 6 sampling steps + 3 forced [IMG1..3]
    _close(tout["hidden"][0][valid], np.asarray(jout["hidden"])[0][valid])


@pytest.mark.parametrize("prompt_kind", ["image_question", "text_only"])
def test_text_route_captions_equal(models, prompt_kind):
    jm, tm = models
    prompts = ([_image(), "Q: hi\nA:"] if prompt_kind == "image_question"
               else ["A picture of"])
    kw = dict(num_words=8, min_word_tokens=8)
    want = jm.generate_for_images_and_texts(prompts, **kw)
    got = tm.generate_for_images_and_texts(prompts, **kw)
    assert got == want and isinstance(got[0], str)


def test_img_route_matches_without_sd(models):
    """Forced [IMG]: retrieval (paths are not URLs: nothing loads), the
    decision MLP and GILLMapper; the SD branch off on both sides, so the
    generation embedding itself is compared."""
    jm, tm = models
    jsd, tsd = jm.sd_pipe, tm.sd_pipe
    jm.sd_pipe = tm.sd_pipe = None
    try:
        kw = dict(num_words=3, gen_scale_factor=1e6)
        want = jm.generate_for_images_and_texts(["x"], **kw)
        got = tm.generate_for_images_and_texts(["x"], **kw)
    finally:
        jm.sd_pipe, tm.sd_pipe = jsd, tsd
    assert len(got) == len(want) == 2
    assert got[0] == want[0] and got[0].endswith("[IMG0][IMG1][IMG2][IMG3]")
    assert got[1]["ret"] == want[1]["ret"] == []
    assert got[1]["decision"][0] == want[1]["decision"][0]
    np.testing.assert_allclose(got[1]["decision"][1:], want[1]["decision"][1:],
                               atol=1e-5)
    assert got[1]["gen"][0].shape == (1, 6, 12)
    _close(got[1]["gen"][0], want[1]["gen"][0])


def test_sd_images_match_on_shared_latents(models):
    jm, tm = models
    rng = np.random.RandomState(12)
    emb = (0.5 * rng.randn(1, 6, 12)).astype(np.float32)
    lat = rng.randn(1, 8, 8, 4).astype(np.float32)
    want = jm.sd_pipe(prompt_embeds=jnp.asarray(emb), latents=jnp.asarray(lat),
                      num_inference_steps=STEPS, guidance_scale=7.5)
    got = tm.sd_pipe(prompt_embeds=torch.from_numpy(emb),
                     latents=torch.from_numpy(lat),
                     num_inference_steps=STEPS, guidance_scale=7.5)
    assert tuple(got.shape) == (1, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_port_full_img_route_with_sd(models):
    """The port's full [IMG] branch: SD image and CLIP re-rank score."""
    _, tm = models
    out = tm.generate_for_images_and_texts(
        ["x"], num_words=3, gen_scale_factor=1e6, num_inference_steps=STEPS,
        generator=torch.Generator().manual_seed(1))
    assert len(out) == 2 and out[0].endswith("[IMG3]")
    (img, score), = out[1]["gen"]
    assert isinstance(img, Image.Image) and img.size == (16, 16)
    assert np.isfinite(score) and out[1]["decision"][0] in ("gen", "ret")


def _batch_prompts():
    return [[_image(), "Q: hi\nA:"], ["A picture of"],
            [_image(), _image(), "Q: which?\nA:"]]


@pytest.mark.parametrize("precision", ["bf16", "w8"])
def test_batch_api_matches_gill_tpu(models, precision):
    """generate_for_images_and_texts_batch end to end on both packages:
    three prompts on the text route, then two forced through [IMG]
    (retrieval, the decision MLP and GILLMapper; SD off on both sides so
    the generation embeddings themselves are compared). "w8": gill_tpu's
    W8 LM tree carried into the port (same int8 weights), the engines on
    its dequant form."""
    from gill_tpu.api import GILL as JGILL
    from gill_tpu_torch.api import GILL as TGILL

    jm, tm = models
    if precision == "w8":
        jm = JGILL(jm.core, jm.params, jm.tokenizer,
                   retrieval_index=jm.index,
                   decision_params=jm.decision_params,
                   lm_weight_precision="w8")
        tm = TGILL(tm.core, gill_params_from_jax(jax.device_get(jm.params)),
                   tm.tokenizer, device="cpu", retrieval_index=tm.index,
                   decision_params=tm.decision_params)
        assert tm.params["lm"]["layers"]["fc1"]["w8"].dtype == torch.int8
    kw = dict(num_words=8, min_word_tokens=8, slots=2, chunk=3)
    want = jm.generate_for_images_and_texts_batch(_batch_prompts(), **kw)
    got = tm.generate_for_images_and_texts_batch(_batch_prompts(), **kw)
    assert got == want and all(isinstance(o[0], str) for o in got)

    jsd, tsd = jm.sd_pipe, tm.sd_pipe
    jm.sd_pipe = tm.sd_pipe = None
    try:
        kw = dict(num_words=3, gen_scale_factor=1e6, slots=2, chunk=2)
        want = jm.generate_for_images_and_texts_batch([["x"], ["y z"]], **kw)
        got = tm.generate_for_images_and_texts_batch([["x"], ["y z"]], **kw)
    finally:
        jm.sd_pipe, tm.sd_pipe = jsd, tsd
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[0].endswith("[IMG0][IMG1][IMG2][IMG3]")
        assert g[1]["ret"] == w[1]["ret"] == []
        assert g[1]["decision"][0] == w[1]["decision"][0]
        _close(g[1]["gen"][0], w[1]["gen"][0])


def test_port_int8_sd_img_route(ckpt_dir, monkeypatch):
    """load_gill(sd_precision="int8") on the tiny checkpoint: the W8A8 UNet
    drives the forced [IMG] route to a finite image."""
    from gill_tpu_torch.api import load_gill as tload_gill

    monkeypatch.setenv("GILL_TPU_TINY_SD", "1")
    tm = tload_gill(str(ckpt_dir), device="cpu",
                    decision_model_fn="decision_model.npz", load_sd=True,
                    dtype=torch.float32, sd_precision="int8")
    assert tm.sd_pipe.quantized and "wq" in tm.sd_pipe.params["unet"]["conv_in"]
    images = []
    decode = tm.sd_pipe.decode_latents
    monkeypatch.setattr(tm.sd_pipe, "decode_latents",
                        lambda lat: images.append(decode(lat)) or images[-1])
    out = tm.generate_for_images_and_texts(["A picture of"], num_words=4,
                                           gen_scale_factor=1e6,
                                           num_inference_steps=3)
    assert len(out) == 2 and isinstance(out[1], dict)
    assert len(out[1]["gen"]) == 1 and len(images) == 1
    size = tm.sd_pipe.cfg.default_size
    assert tuple(images[0].shape) == (1, size, size, 3)
    assert bool(torch.isfinite(images[0]).all())
    with pytest.raises(ValueError):
        tload_gill(str(ckpt_dir), device="cpu", load_sd=False,
                   sd_precision="fp8")
