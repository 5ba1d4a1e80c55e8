"""Shared tiny models for the CPU tests of the port's evals, demo, examples
and scripts (tests/test_torch_{evals,apps,tools}.py).

`ckpt_dir(root)` writes tests/test_load_gill.py's tiny checkpoint
directory (no retrieval blob, no decision model: the eval scripts load
without them). `load_pair(root)` loads it with the port on the CPU in
fp32 (GILL_TPU_TINY_SD=1) and builds gill_tpu's GILL and SD pipeline over
the same parameters (weights/from_jax.py `tree_to_numpy`; gill_tpu's
eager init costs seconds, its UNet's ~19 s). `share_latents` makes two
pipelines denoise the same seeded latents, so images can be compared, and
records each call's embeddings and images.
`jax_script` / `run_jax` import gill_tpu's scripts by path and run their
`main()` with `sys.argv` set.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch


ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def jax_script(rel: str):
    """gill_tpu's script at `rel` (from the repository root), imported by
    path as a module of its own."""
    path = os.path.join(ROOT, rel)
    spec = importlib.util.spec_from_file_location(
        "jax_" + os.path.splitext(os.path.basename(path))[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(monkeypatch, rel: str, argv, model=None):
    """gill_tpu's script `rel` through its main() with `argv`; `model`, if
    given, is what its `load_gill` returns."""
    mod = jax_script(rel)
    if model is not None:
        import gill_tpu.api

        monkeypatch.setattr(gill_tpu.api, "load_gill", lambda *a, **k: model)
    monkeypatch.setattr(sys, "argv", [rel] + list(argv))
    return mod.main()


def ckpt_dir(root) -> str:
    """tests/test_load_gill.py's tiny checkpoint directory, its adapters
    from the port's torch init (gill_tpu's eager init costs seconds)."""
    from gill_tpu_torch.config import GILLConfig
    from gill_tpu_torch.models.gill import GILLCore
    from gill_tpu_torch.nn.core import Init
    from gill_tpu_torch.tokenizer import (GPT2BPETokenizer,
                                          setup_gill_tokenizer)
    from gill_tpu_torch.utils.ckpt import save_checkpoint

    root = str(root)
    cfg = GILLConfig(opt_version="test/opt-tiny",
                     visual_encoder="test/clip-tiny",
                     n_visual_tokens=2, num_tokens=4, num_clip_tokens=6,
                     ret_emb_dim=8, gen_emb_dim=12, image_size=16)
    cfg.to_json(os.path.join(root, "model_args.json"))
    tok = GPT2BPETokenizer.tiny()
    img_ids = setup_gill_tokenizer(tok, 4)
    core = GILLCore.build(cfg, vocab_len=len(tok), img_start=img_ids[0],
                          pad_token_id=tok.pad_token_id,
                          bos_token_id=tok.bos_token_id)
    save_checkpoint({"adapters": core.init_adapters(
        Init(torch.Generator().manual_seed(7), "cpu"))}, root, step=5)
    return root


def load_pair(root: str, sd: bool = True):
    """(gill_tpu GILL, port GILL) on the same parameters, fp32, CPU: the
    port's `load_gill` (random backbones from its torch init), and
    gill_tpu's GILL built as its load_gill builds one, over the port's
    parameters."""
    from gill_tpu.api import GILL as JGILL
    from gill_tpu.config import GILLConfig as JConfig
    from gill_tpu.models.gill import GILLCore as JCore
    from gill_tpu.models.sd.pipeline import StableDiffusionPipeline as JPipe
    from gill_tpu.models.sd.pipeline import tiny_sd_config as jtiny
    from gill_tpu.tokenizer import GPT2BPETokenizer as JTok
    from gill_tpu.tokenizer import setup_gill_tokenizer as jsetup
    from gill_tpu_torch.api import load_gill as tload_gill
    from gill_tpu_torch.weights.from_jax import tree_to_numpy

    old = os.environ.get("GILL_TPU_TINY_SD")
    os.environ["GILL_TPU_TINY_SD"] = "1"
    try:
        tm = tload_gill(root, device="cpu", load_ret_embs=False,
                        decision_model_fn=None, load_sd=sd,
                        dtype=torch.float32)
    finally:
        if old is None:
            del os.environ["GILL_TPU_TINY_SD"]
        else:
            os.environ["GILL_TPU_TINY_SD"] = old
    cfg = JConfig.from_json(os.path.join(root, "model_args.json"))
    tok = JTok.tiny()
    img_ids = jsetup(tok, cfg.num_tokens)
    core = JCore.build(cfg, vocab_len=len(tok), img_start=img_ids[0],
                       pad_token_id=tok.pad_token_id,
                       bos_token_id=tok.bos_token_id)
    assert (core.vocab_len, core.img_start) == (tm.core.vocab_len,
                                                tm.core.img_start)
    jm = JGILL(core, jax.tree_util.tree_map(jnp.asarray,
                                            tree_to_numpy(tm.params)), tok)
    if sd:
        scfg = jtiny()
        scfg.unet.cross_attention_dim = cfg.gen_emb_dim
        scfg.text.max_positions = cfg.num_clip_tokens
        jm.sd_pipe = JPipe(scfg, jax.tree_util.tree_map(
            jnp.asarray, tree_to_numpy(tm.sd_pipe.params)))
    return jm, tm


class _Latents:
    """The same seeded latents for every call of either side."""

    def __init__(self, shape, seed: int):
        self.arr = np.random.RandomState(seed).randn(*shape).astype(
            np.float32)


def share_latents(jp, tp, seed: int = 11, steps=None):
    """Both SD pipelines (gill_tpu's, the port's) denoise the same latents
    a call (the random streams of the two packages differ) until
    `unshare`, in `steps` denoising steps when given (whatever the caller
    asks: a script's 50 cost the CPU tests seconds a call); returns the
    (gill_tpu, port) call records: [(prompt embeddings, images)] as
    numpy."""
    size = tp.cfg.default_size // tp.cfg.vae_scale
    lat = _Latents((1, size, size, tp.cfg.vae.latent_channels), seed).arr
    jrec, trec = [], []

    def rows(prompt_embeds, kw):
        return len(kw["prompt"]) if prompt_embeds is None else \
            prompt_embeds.shape[0]

    class JShared(type(jp)):
        def __call__(self, prompt_embeds=None, **kw):
            kw.pop("rng", None)
            if steps is not None:
                kw["num_inference_steps"] = steps
            out = super().__call__(
                prompt_embeds=prompt_embeds, latents=jnp.asarray(
                    np.repeat(lat, rows(prompt_embeds, kw), 0)), **kw)
            jrec.append((None if prompt_embeds is None else
                         np.asarray(prompt_embeds), np.asarray(out)))
            return out

    class TShared(type(tp)):
        def __call__(self, prompt_embeds=None, **kw):
            kw.pop("generator", None)
            if steps is not None:
                kw["num_inference_steps"] = steps
            out = super().__call__(
                prompt_embeds=prompt_embeds, latents=torch.from_numpy(
                    np.repeat(lat, rows(prompt_embeds, kw), 0)), **kw)
            trec.append((None if prompt_embeds is None else
                         prompt_embeds.detach().float().numpy(),
                         out.float().numpy()))
            return out

    jp.__class__, tp.__class__ = JShared, TShared
    return jrec, trec


def unshare(*pipes):
    for p in pipes:
        p.__class__ = p.__class__.__bases__[0]


def assert_records_close(jrec, trec, rtol: float = 1e-4):
    """Each SD call's prompt embeddings within rtol (relative to the
    largest), its images within 1e-4 on [0, 1] pixels."""
    assert len(jrec) == len(trec) > 0
    for (je, ji), (te, ti) in zip(jrec, trec):
        np.testing.assert_allclose(te, je, rtol=rtol,
                                   atol=rtol * max(1.0, np.abs(je).max()))
        np.testing.assert_allclose(ti, ji, atol=1e-4)
