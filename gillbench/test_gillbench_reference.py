"""The plain reference against the port at the port's tiny presets, in fp32
on the CPU: the two compute the same functions."""

import numpy as np
import pytest
import torch
from PIL import Image

from gillbench import build, tiny, weights
from gillbench.reference import gill as rg
from gillbench.reference import opt as ropt
from gillbench.reference import sd as rsd

torch.set_num_threads(2)
CPU = torch.device("cpu")


def close(a, b, tol=2e-5):
    a, b = a.float(), b.float()
    err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))
    assert err < tol, err


def trees(*builds, seed=3):
    return weights.seeded_trees([(b, torch.float32) for b in builds],
                                weights.generator(seed, CPU), CPU)


def test_opt_forward():
    from gill_tpu_torch.config import OPTConfig
    from gill_tpu_torch.models import opt as opt_mod

    oc = OPTConfig.from_name(tiny.OPT_TINY["name"])
    (lm,) = trees(lambda i: opt_mod.init(i, oc))
    x = torch.randn(1, 23, oc.hidden_size)
    want = opt_mod.forward(lm, oc, x, skip_logits=True)["last_hidden"]
    close(ropt.forward(lm, tiny.OPT_TINY, x), want)


def test_clip_pixels_and_text_ids():
    from gill_tpu_torch.tokenizer import GPT2BPETokenizer
    from gill_tpu_torch.utils.image import clip_preprocess

    img = Image.fromarray(np.random.RandomState(0).randint(
        0, 256, (40, 56, 3), dtype=np.uint8))
    np.testing.assert_array_equal(rg.clip_pixels(img, 16),
                                  clip_preprocess(img, 16))
    tok = GPT2BPETokenizer(rg.byte_vocab(280), merges=[])
    text = "Q: a red boat near the lake?\nA: yes, café 42\nA:"
    assert rg.text_ids(text) == tok.encode(text)
    assert len(rg.byte_vocab(50265)) == 50265


@pytest.fixture(scope="module")
def gill_trees():
    from gill_tpu_torch.config import CLIPVisionConfig
    from gill_tpu_torch.models import clip as clip_mod
    from gill_tpu_torch.models.sd import unet as unet_mod
    from gill_tpu_torch.models.sd import vae as vae_mod

    cfg = tiny.GILL_TINY
    sd = build.sd_config(cfg)
    vc = CLIPVisionConfig.from_name(cfg["clip"]["name"])
    vision, unet, vae = trees(lambda i: clip_mod.init_vision(i, vc),
                              lambda i: unet_mod.init(i, sd.unet),
                              lambda i: vae_mod.init_decoder(i, sd.vae))
    return {"vision": vision, "unet": unet, "vae": vae, "sd": sd, "vc": vc}


def test_clip_vision(gill_trees):
    from gill_tpu_torch.models import clip as clip_mod

    px = torch.randn(2, 16, 16, 3)
    want = clip_mod.vision_forward(gill_trees["vision"], gill_trees["vc"],
                                   px)["pooler_output"]
    close(rg.vision_pooled(gill_trees["vision"], tiny.GILL_TINY["clip"], px),
          want)


def test_gill_mapper():
    from gill_tpu_torch.config import MapperConfig
    from gill_tpu_torch.models import mapper as mapper_mod

    mc = MapperConfig(in_dim=16, out_dim=24, num_input_tokens=8,
                      num_output_tokens=16, mode="gill_mapper")
    (p,) = trees(lambda i: mapper_mod.init(i, mc))
    x, e = torch.randn(1, 8, 16), torch.randn(1, 8, 16)
    close(rg.gill_mapper(p, tiny.GILL_TINY["gill"]["mapper"], x, e),
          mapper_mod.apply(p, mc, x, e))


def test_unet(gill_trees):
    from gill_tpu_torch.models.sd import unet as unet_mod

    lat, ctx = torch.randn(2, 8, 8, 4), torch.randn(2, 16, 24)
    want = unet_mod.apply(gill_trees["unet"], gill_trees["sd"].unet, lat,
                          torch.tensor(421.0), ctx)
    close(rsd.unet(gill_trees["unet"], tiny.GILL_TINY["unet"], lat, 421,
                   ctx), want, 1e-4)


def test_vae_decode(gill_trees):
    from gill_tpu_torch.models.sd import vae as vae_mod

    lat = torch.randn(2, 8, 8, 4)
    want = vae_mod.decode(gill_trees["vae"], gill_trees["sd"].vae, lat)
    close(rsd.vae_decode(gill_trees["vae"], tiny.GILL_TINY["vae"], lat),
          torch.clamp(want / 2 + 0.5, 0, 1), 1e-4)


def test_pndm_denoise(gill_trees):
    from gill_tpu_torch.models.sd.pipeline import StableDiffusionPipeline

    pipe = StableDiffusionPipeline(gill_trees["sd"], {
        "unet": gill_trees["unet"], "vae_decoder": gill_trees["vae"]})
    ctx, lat = torch.randn(1, 16, 24), torch.randn(1, 8, 8, 4)
    want = pipe(prompt_embeds=ctx, latents=lat, num_inference_steps=6,
                guidance_scale=7.5, output_latents=True)
    got = rsd.generate(gill_trees["unet"], tiny.GILL_TINY["unet"], ctx, lat,
                       6, 7.5)
    close(got, want, 1e-4)
