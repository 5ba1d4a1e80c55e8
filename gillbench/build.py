"""The systems under test, made from a configuration file and --seed.

The configuration file's numbers are held against the port's own
configuration objects, so a run refuses a file that is not what it runs.
Weights come from `weights.seeded_trees` in the port's layout; the same
tensors go to the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from gillbench import weights
from gillbench.harness import BenchError
from gillbench.reference.gill import byte_vocab

OPT_KEYS = {"hidden_size": "hidden_size", "ffn_dim": "ffn_dim",
            "num_hidden_layers": "num_layers",
            "num_attention_heads": "num_heads",
            "word_embed_proj_dim": "word_embed_proj_dim",
            "vocab_size": "vocab_size",
            "max_position_embeddings": "max_positions",
            "do_layer_norm_before": "do_layer_norm_before"}
CLIP_KEYS = {"hidden_size": "hidden_size",
             "intermediate_size": "intermediate_size",
             "num_hidden_layers": "num_layers",
             "num_attention_heads": "num_heads", "image_size": "image_size",
             "patch_size": "patch_size"}
UNET_KEYS = {"block_out_channels": "block_out_channels",
             "layers_per_block": "layers_per_block",
             "cross_attention_dim": "cross_attention_dim",
             "attention_head_dim": "num_heads",
             "norm_num_groups": "norm_groups", "in_channels": "in_channels",
             "out_channels": "out_channels"}
VAE_KEYS = {"block_out_channels": "block_out_channels",
            "layers_per_block": "layers_per_block",
            "latent_channels": "latent_channels",
            "norm_num_groups": "norm_groups"}
GILL_KEYS = ("num_tokens", "num_clip_tokens", "gen_emb_dim", "ret_emb_dim",
             "n_visual_tokens")


def _hold(group: dict, obj, keys: dict, what: str):
    for k, attr in keys.items():
        want, got = group[k], getattr(obj, attr)
        if isinstance(got, tuple):
            got = list(got)
        if want != got:
            raise BenchError(f"{what}.{k}: the file says {want!r}, the port "
                             f"runs {got!r}")


def sd_config(cfg: dict):
    """The port's SD pipeline configuration the file names: SD v1.5, or the
    port's tiny one (CPU tests), fitted to GILL's conditioning as the port's
    load_gill fits it."""
    from gill_tpu_torch.config import SDPipelineConfig, tiny_sd_config

    if not cfg["sd"].get("tiny"):
        return SDPipelineConfig()
    sd = tiny_sd_config()
    sd.unet.cross_attention_dim = cfg["gill"]["gen_emb_dim"]
    sd.text.max_positions = cfg["gill"]["num_clip_tokens"]
    return sd


@dataclasses.dataclass
class GillSystem:
    model: object           # gill_tpu_torch.api.GILL
    trees: dict             # the seeded inputs: lm, vision, adapters, unet,
                            # vae_decoder, decision, index
    img0: int


def gill_system(cfg: dict, seed: int, device, *, lm_precision="bf16",
                sd_precision="bf16", index_rows=None) -> GillSystem:
    """GILL with OPT, CLIP ViT, its adapters, SD v1.5 and a retrieval index,
    every weight seeded; prompts' text goes through an OPT-sized byte-level
    vocabulary (the benchmark's input, byte_vocab)."""
    from gill_tpu_torch.api import GILL
    from gill_tpu_torch.config import CLIPVisionConfig, GILLConfig
    from gill_tpu_torch.models import clip as clip_mod
    from gill_tpu_torch.models import opt as opt_mod
    from gill_tpu_torch.models.gill import GILLCore
    from gill_tpu_torch.models.sd import unet as unet_mod
    from gill_tpu_torch.models.sd import vae as vae_mod
    from gill_tpu_torch.models.sd.pipeline import StableDiffusionPipeline
    from gill_tpu_torch.retrieval import RetrievalIndex
    from gill_tpu_torch.tokenizer import (GPT2BPETokenizer,
                                          setup_gill_tokenizer)

    gc = cfg["gill"]
    gcfg = GILLConfig(opt_version=cfg["opt"]["name"],
                      visual_encoder=cfg["clip"]["name"],
                      image_size=cfg["clip"]["image_size"],
                      **{k: gc[k] for k in GILL_KEYS})
    _hold(cfg["opt"], gcfg.opt, OPT_KEYS, "opt")
    _hold(cfg["clip"], CLIPVisionConfig.from_name(cfg["clip"]["name"]),
          CLIP_KEYS, "clip")
    mc = gc["mapper"]
    sd_cfg = sd_config(cfg)
    _hold(cfg["unet"], sd_cfg.unet, UNET_KEYS, "unet")
    _hold(cfg["vae"], sd_cfg.vae, VAE_KEYS, "vae")
    if (sd_cfg.default_size, sd_cfg.vae_scale) != (cfg["sd"]["size"],
                                                   cfg["sd"]["vae_scale"]):
        raise BenchError("sd.size / sd.vae_scale differ from the port's")
    tok = GPT2BPETokenizer(byte_vocab(cfg["tokenizer_size"]), merges=[])
    img_ids = setup_gill_tokenizer(tok, gcfg.num_tokens)
    core = GILLCore.build(gcfg, vocab_len=len(tok), img_start=img_ids[0],
                          pad_token_id=tok.pad_token_id,
                          bos_token_id=tok.bos_token_id)
    gm = core.gen_mapper_cfg
    _hold(mc, gm, {"hidden_dim": "hidden_dim", "heads": "num_heads",
                   "ffn_dim": "ffn_dim", "encoder_layers": "num_encoder_layers",
                   "decoder_layers": "num_decoder_layers"}, "gill.mapper")
    bf = torch.bfloat16
    g = weights.generator(seed, device)
    lm, vision, adapters, unet, vae, dec = weights.seeded_trees([
        (lambda i: opt_mod.resize_embeddings(
            opt_mod.init(i, core.opt_cfg), core.vocab_len, i), bf),
        (lambda i: clip_mod.init_vision(i, core.vis_cfg), bf),
        (core.init_adapters, torch.float32),
        (lambda i: unet_mod.init(i, sd_cfg.unet), bf),
        (lambda i: vae_mod.init_decoder(i, sd_cfg.vae), bf),
        (lambda i: i.linear(core.lm_dim, 2), torch.float32),
    ], g, device)
    params = {"lm": lm, "vision": vision, "adapters": adapters}
    rows = cfg["index_rows"] if index_rows is None else index_rows
    emb = torch.randn((rows, gcfg.ret_emb_dim), device=device, generator=g)
    scale = float(torch.exp(adapters["logit_scale"].float()))
    # row paths are not URLs: every fetch of a retrieved image fails at once
    index = RetrievalIndex([f"cc3m/{i:07d}.jpg" for i in range(rows)], emb,
                           scale, device=device)
    pipe = StableDiffusionPipeline(sd_cfg, {"unet": unet, "vae_decoder": vae},
                                   quantize=(sd_precision == "int8"))
    model = GILL(core, params, tok, device=device, sd_pipe=pipe,
                 retrieval_index=index, decision_params=dec,
                 lm_weight_precision=lm_precision)
    del emb
    trees = {"lm": lm, "vision": vision, "adapters": adapters, "unet": unet,
             "vae_decoder": vae, "decision": dec}
    return GillSystem(model, trees, img_ids[0])
