"""TextFcLayer: maps LM hidden states at the [IMG] positions to visual
output spaces (counterpart of gill_tpu/models/mapper.py; reference
gill/layers.py:5-53).

  * 'linear'      — one Linear; output truncated to num_output_tokens
                    (the retrieval head: 8 in-tokens -> 1 out-token).
  * 'gill_mapper' — (x + input_embs) -> Linear(in, 512) -> 4-encoder /
                    4-decoder pre-norm transformer (nhead 4, ff 2048, relu,
                    final norms, no masks) over num_output_tokens learned
                    queries -> Linear(512, out) (the generation head,
                    8 -> 77 x 768), as torch.nn.Transformer(norm_first=True).
"""

from __future__ import annotations

from typing import Optional

import torch

from gill_tpu_torch.config import MapperConfig
from gill_tpu_torch.nn import core as nn


def init(init: nn.Init, cfg: MapperConfig):
    if cfg.mode == "linear":
        return {"model": init.linear(cfg.in_dim, cfg.out_dim)}
    if cfg.mode != "gill_mapper":
        raise ValueError(cfg.mode)
    d, ff = cfg.hidden_dim, cfg.ffn_dim
    ne, nd = (cfg.num_encoder_layers,), (cfg.num_decoder_layers,)
    return {
        "fc": init.linear(cfg.in_dim, d),
        "tfm": {
            "encoder": {"layers": {
                "self_attn": init.mha(d, lead=ne),
                "ln1": init.layer_norm(d, ne),
                "fc1": init.linear(d, ff, lead=ne),
                "fc2": init.linear(ff, d, lead=ne),
                "ln2": init.layer_norm(d, ne)},
                "norm": init.layer_norm(d)},
            "decoder": {"layers": {
                "self_attn": init.mha(d, lead=nd),
                "cross_attn": init.mha(d, lead=nd),
                "ln1": init.layer_norm(d, nd),
                "ln2": init.layer_norm(d, nd),
                "ln3": init.layer_norm(d, nd),
                "fc1": init.linear(d, ff, lead=nd),
                "fc2": init.linear(ff, d, lead=nd)},
                "norm": init.layer_norm(d)},
        },
        "model": init.linear(d, cfg.out_dim),
        "query_embs": init.normal((1, cfg.num_output_tokens, d), 1.0),
    }


def _ff(lp, x):
    return nn.linear(lp["fc2"], torch.relu(nn.linear(lp["fc1"], x)))


def _transformer(p, src, tgt, *, num_heads: int, eps: float):
    enc = p["encoder"]["layers"]
    h = src
    for i in range(enc["ln1"]["scale"].shape[0]):
        lp = nn.layer_view(enc, i)
        h = h + nn.mha_apply(lp["self_attn"], nn.layer_norm(lp["ln1"], h, eps),
                             num_heads=num_heads)
        h = h + _ff(lp, nn.layer_norm(lp["ln2"], h, eps))
    mem = nn.layer_norm(p["encoder"]["norm"], h, eps)

    dec = p["decoder"]["layers"]
    h = tgt
    for i in range(dec["ln1"]["scale"].shape[0]):
        lp = nn.layer_view(dec, i)
        h = h + nn.mha_apply(lp["self_attn"], nn.layer_norm(lp["ln1"], h, eps),
                             num_heads=num_heads)
        h = h + nn.mha_apply(lp["cross_attn"], nn.layer_norm(lp["ln2"], h, eps),
                             mem, num_heads=num_heads)
        h = h + _ff(lp, nn.layer_norm(lp["ln3"], h, eps))
    return nn.layer_norm(p["decoder"]["norm"], h, eps)


def apply(params, cfg: MapperConfig, x, input_embs: Optional[torch.Tensor] = None):
    """x: (N, T_in, in_dim); input_embs: (N, T_in, in_dim) or None.

    Returns (N, num_output_tokens, out_dim) for gill_mapper;
    (N, min(T_in, num_output_tokens), out_dim) for linear."""
    if cfg.mode == "gill_mapper":
        if input_embs is not None:
            x = x + input_embs
        x = nn.linear(params["fc"], x)
        q = params["query_embs"].to(x.dtype)
        queries = q.expand((x.shape[0],) + tuple(q.shape[1:]))
        x = _transformer(params["tfm"], x, queries, num_heads=cfg.num_heads,
                         eps=cfg.layer_norm_eps)
        return nn.linear(params["model"], x)
    # linear mode: no input_embs addition (reference layers.py:31-32),
    # truncated to num_output_tokens (layers.py:46-48)
    return nn.linear(params["model"], x)[:, :cfg.num_output_tokens, :]
