"""gill_tpu_torch/models/safety.py against gill_tpu/models/safety.py
(mirrors test_safety.py), on the diffusers-layout state dict of a random
`transformers` CLIPVisionModelWithProjection plus concept buffers:

  * the resize within 1e-6 of `jax.image.resize(..., "bicubic")` (Keys
    a = -0.5, antialiased; fp32 sums in another order);
  * the unrounded scores within 1e-5 of gill_tpu's and the flags equal on
    every image whose scores lie further than that from the rounding
    boundary (round3(s) > 0 flips at s = 5e-4);
  * thresholds of +10 / -10: nothing / everything flagged and blacked out;
  * the pipeline hook, and `load_safety_checker` from a directory.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gill_tpu.models import clip as jclip
from gill_tpu.models import safety as jsafety
from gill_tpu.weights.convert import safety_checker_from_torch as jconvert
from gill_tpu_torch.models import safety as tsafety
from gill_tpu_torch.weights.convert import safety_checker_from_torch
from gill_tpu_torch.weights.from_jax import tree_from_jax, tree_to_numpy
from torch_threads import one_intra_op_thread  # noqa: F401

pytest.importorskip("transformers")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _cfgs():
    from test_safety import CFG

    vis = dataclasses.asdict(CFG.vision)
    tcfg = tsafety.SafetyCheckerConfig(
        vision=tsafety.CLIPVisionConfig(**vis),
        projection_dim=CFG.projection_dim, num_concepts=CFG.num_concepts,
        num_special=CFG.num_special)
    return CFG, tcfg


def _params(seed=0):
    from test_safety import _fake_diffusers_sd

    jcfg, tcfg = _cfgs()
    sd = _fake_diffusers_sd(seed)[1]
    jp = jax.tree_util.tree_map(jnp.asarray, jconvert(sd, jcfg))
    tp = tree_from_jax(safety_checker_from_torch(sd, tcfg))
    return jp, tp


def _jax_scores(params, cfg, images):
    """gill_tpu's check_images up to the unrounded scores."""
    b, sz = images.shape[0], cfg.vision.image_size
    px = jax.image.resize(jnp.asarray(images), (b, sz, sz, 3),
                          method="bicubic")
    px = (px - jnp.asarray(jsafety._MEAN)) / jnp.asarray(jsafety._STD)
    pooled = jclip.vision_forward(params["vision"], cfg.vision,
                                  px)["pooler_output"]
    emb = pooled @ params["vision"]["visual_projection"]["w"]
    special = jsafety._cosine(emb, params["special_care_embeds"]) \
        - params["special_care_embeds_weights"][None, :]
    concept = jsafety._cosine(emb, params["concept_embeds"]) \
        - params["concept_embeds_weights"][None, :]
    return np.asarray(special), np.asarray(concept)


def test_config_matches_gill_tpu():
    for j, t in ((jsafety.SafetyCheckerConfig(),
                  tsafety.SafetyCheckerConfig()),
                 (jsafety.tiny_safety_config(), tsafety.tiny_safety_config())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("shape", [(512, 512, 224), (48, 40, 32),
                                   (32, 32, 32), (20, 24, 32)])
def test_resize_matches_jax_image_resize(shape):
    h, w, size = shape
    x = np.random.RandomState(h).rand(2, h, w, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, size, size, 3),
                            method="bicubic")
    got = tsafety.resize_bicubic(torch.from_numpy(x), size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("size", [32, 48])
def test_scores_and_flags_match_gill_tpu(size):
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    images = np.random.RandomState(size).rand(8, size, size, 3).astype(
        np.float32)
    # thresholds moved so that about half the images are flagged
    js, jc = _jax_scores(jp, jcfg, images)
    shift = float(np.median(jc.max(1)))
    jp = dict(jp, concept_embeds_weights=jp["concept_embeds_weights"] + shift)
    tp = dict(tp, concept_embeds_weights=tp["concept_embeds_weights"] + shift)
    js, jc = _jax_scores(jp, jcfg, images)
    with torch.no_grad():
        ts, tc = tsafety.scores(tp, tcfg, torch.from_numpy(images))
        tout, tflags = tsafety.check_images(tp, tcfg,
                                            torch.from_numpy(images))
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0, atol=1e-5)
    jout, jflags = jsafety.check_images(jp, jcfg, jnp.asarray(images))
    jflags = np.asarray(jflags)
    adj = np.where((np.round(js * 1000) / 1000 > 0).any(1), 0.01, 0.0)
    margin = np.concatenate([np.abs(js - 5e-4),
                             np.abs(jc + adj[:, None] - 5e-4)], 1).min(1)
    clear = margin > 1e-5
    assert clear.sum() >= 6
    np.testing.assert_array_equal(tflags.numpy()[clear], jflags[clear])
    assert 0 < jflags[clear].sum() < clear.sum()   # both branches occur
    for i in np.nonzero(clear)[0]:
        if jflags[i]:
            assert not bool(tout[i].any())
        else:
            np.testing.assert_array_equal(tout[i].numpy(), images[i])


def test_threshold_branches():
    _, tcfg = _cfgs()
    _, tp = _params(1)
    images = torch.from_numpy(np.random.RandomState(1).rand(
        4, 32, 32, 3).astype(np.float32))
    clean = dict(tp, concept_embeds_weights=tp["concept_embeds_weights"] + 10,
                 special_care_embeds_weights=tp[
                     "special_care_embeds_weights"] + 10)
    out, flags = tsafety.check_images(clean, tcfg, images)
    assert not bool(flags.any()) and torch.equal(out, images)
    hot = dict(tp, concept_embeds_weights=tp["concept_embeds_weights"] - 10)
    out, flags = tsafety.check_images(hot, tcfg, images)
    assert bool(flags.all()) and not bool(out.any())
    out, flags = tsafety.SafetyChecker(tcfg, hot)(images)
    assert flags == [True] * 4 and not bool(out.any())


def test_safety_checker_in_pipeline():
    """The SafetyChecker plugs into the SD pipeline's hook (gill_tpu's
    case), and with thresholds of -10 the pipeline returns black images."""
    from gill_tpu_torch.config import tiny_sd_config
    from gill_tpu_torch.models.sd import unet as tunet
    from gill_tpu_torch.models.sd import vae as tvae
    from gill_tpu_torch.models.sd.pipeline import StableDiffusionPipeline
    from gill_tpu_torch.nn.core import Init

    cfg = tsafety.tiny_safety_config()
    init = Init(torch.Generator().manual_seed(0), "cpu")
    cparams = tsafety.init(init, cfg)
    sd_cfg = tiny_sd_config()
    params = {"unet": tunet.init(init, sd_cfg.unet),
              "vae_decoder": tvae.init_decoder(init, sd_cfg.vae)}
    emb = torch.zeros(2, sd_cfg.text.max_positions,
                      sd_cfg.unet.cross_attention_dim)
    for weights, black in ((cparams["concept_embeds_weights"] + 10, False),
                           (cparams["concept_embeds_weights"] - 10, True)):
        checker = tsafety.SafetyChecker(
            cfg, dict(cparams, concept_embeds_weights=weights))
        pipe = StableDiffusionPipeline(sd_cfg, params, safety_checker=checker)
        with torch.no_grad():
            img = pipe(prompt_embeds=emb, num_inference_steps=2,
                       guidance_scale=1.0,
                       generator=torch.Generator().manual_seed(1))
        assert tuple(img.shape) == (2, sd_cfg.default_size,
                                    sd_cfg.default_size, 3)
        assert bool(torch.isfinite(img).all())
        assert (not bool(img.any())) == black


def test_load_safety_checker_matches_gill_tpu(tmp_path, monkeypatch):
    """From a diffusers safety_checker/ directory written by chip_smoke's
    writer: the same params as gill_tpu's loader, in the requested dtype."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(2)
    chip_smoke.write_safetensors(str(tmp_path / "model.safetensors"),
                                 chip_smoke.safety_to_diffusers(tp))
    monkeypatch.setattr(jsafety, "SafetyCheckerConfig", lambda: jcfg)
    monkeypatch.setattr(tsafety, "SafetyCheckerConfig", lambda: tcfg)
    want = jsafety.load_safety_checker(str(tmp_path), dtype=jnp.float32)
    got = tsafety.load_safety_checker(str(tmp_path), device="cpu",
                                      dtype=torch.float32)
    got_np = tree_to_numpy(got.params)            # gill_tpu's layout
    flat_w = jax.tree_util.tree_leaves_with_path(want.params)
    assert len(flat_w) == len(jax.tree_util.tree_leaves(got_np))
    for path, w in flat_w:
        node = got_np
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(w))
    bf = tsafety.load_safety_checker(str(tmp_path), device="cpu",
                                     dtype=torch.bfloat16)
    assert bf.params["concept_embeds"].dtype == torch.bfloat16
