"""A tiny configuration and mix of the GILL driver, for the CPU tests: the
same code paths at sizes a test run holds (the port's test presets)."""

from __future__ import annotations

import copy

from gillbench.harness import Cell

OPT_TINY = {"name": "test/opt-tiny", "hidden_size": 16, "ffn_dim": 32,
            "num_hidden_layers": 2, "num_attention_heads": 2,
            "word_embed_proj_dim": 16, "vocab_size": 300,
            "max_position_embeddings": 96, "do_layer_norm_before": True,
            "layer_norm_eps": 1e-05}

GILL_TINY = {
    "name": "gill-tiny", "dtype": "bfloat16", "opt": OPT_TINY,
    "clip": {"name": "test/clip-tiny", "hidden_size": 16,
             "intermediate_size": 32, "num_hidden_layers": 1,
             "num_attention_heads": 2, "image_size": 16, "patch_size": 8,
             "layer_norm_eps": 1e-05},
    "gill": {"num_tokens": 8, "num_clip_tokens": 16, "gen_emb_dim": 24,
             "ret_emb_dim": 8, "n_visual_tokens": 4,
             "mapper": {"hidden_dim": 512, "heads": 4, "ffn_dim": 2048,
                        "encoder_layers": 4, "decoder_layers": 4,
                        "layer_norm_eps": 1e-05}},
    "unet": {"block_out_channels": [32, 64], "layers_per_block": 1,
             "cross_attention_dim": 24, "attention_head_dim": 2,
             "norm_num_groups": 8, "in_channels": 4, "out_channels": 4},
    "vae": {"block_out_channels": [16, 32], "layers_per_block": 1,
            "latent_channels": 4, "norm_num_groups": 4},
    "sd": {"size": 16, "vae_scale": 2, "tiny": True},
    "index_rows": 64, "tokenizer_size": 280, "reduced": []}

GEN_TINY = {
    "driver": "gill_online", "clients": 3, "ramp_s": 0.3, "pool": 8,
    "image": {"size": 32}, "dialogue": {"line_words": [2, 4],
                                        "text_bytes": [10, 30]},
    "request": {"num_words": 4, "gen_scale_factor": 1000000.0,
                "guidance_scale": 7.5, "steps": 3},
    "engine": {"slots": 2, "chunk": 2, "max_seq": 80},
    "sd_queue": {"max_batch": 2, "warm_buckets": [1, 2]},
    # limits from tiny CPU readings (bf16 against fp32): sound runs read
    # hidden 0.0058, cond 0.0010, eps 0.013, image 0.0026-0.0033, score
    # <= 0.0011; the control (W8 LM, W8A8 UNet) reads eps 0.038-0.047
    "check": {"requests": 2, "limits": {"hidden": 0.05, "cond": 0.05,
                                        "eps": 0.025, "image": 0.02,
                                        "score": 0.02}}}


def cell(trace_metrics=()) -> Cell:
    """A Cell of the tiny GILL generation mix, with the per-layer readers of
    `trace_metrics` (BENCHMARK.json entries)."""
    from gillbench.harness import load_metric

    c = Cell({"name": "tiny_gen", "chips": 1}, copy.deepcopy(GILL_TINY),
             copy.deepcopy(GEN_TINY), [], [])
    c.per_layer = list(trace_metrics)
    c.readers = {m["name"]: load_metric(m["name"]) for m in trace_metrics}
    return c
