"""OPT decoder (the frozen LM backbone) over explicit parameter trees.

Counterpart of gill_tpu/models/opt.py: `inputs_embeds` entry point, optional
project_in/project_out, learned positions offset by `position_offset`,
pre- or post-LayerNorm layers, per-layer hidden-state taps, a tied lm head
and a preallocated KV cache `{"k", "v"}` of shape (L, B, S, H, Dh).

Cached calls (`cache` given) take one of three paths, as in gill_tpu:
  * prefill (`cache_pos == 0`): attention over the prompt's own k/v (so the
    flash gate sees the prompt length), then k/v are written at 0..T-1;
  * single-token decode (`T == 1`, `cache_pos > 0`): attention over the
    cache's first `cache_pos` rows plus the token's own k/v, jointly; the
    token's k/v are then written at `cache_pos`;
  * a multi-token chunk at `cache_pos > 0`: k/v are written first and the
    chunk attends over the cache prefix with `kv_offset = cache_pos`.
The cache is updated IN PLACE (gill_tpu returns a new cache) and returned.
Layers run as a Python loop over views of the stacked (L, ...) weights.
"""

from __future__ import annotations

import torch

from gill_tpu_torch.config import OPTConfig
from gill_tpu_torch.nn import core as nn
from gill_tpu_torch.ops.attention import dot_product_attention


def init(init: nn.Init, cfg: OPTConfig):
    """Random parameters with gill_tpu's init distributions, allocated in
    stacked (L, ...) form directly on `init`'s device and dtype."""
    n, d, f = cfg.num_layers, cfg.hidden_size, cfg.ffn_dim
    lead = (n,)
    params = {
        "embed_tokens": init.embedding(cfg.vocab_size, cfg.word_embed_proj_dim),
        "embed_positions": init.embedding(
            cfg.max_positions + cfg.position_offset, d),
        "layers": {
            "attn": {k: init.linear(d, d, lead=lead) for k in "qkvo"},
            "attn_ln": init.layer_norm(d, lead),
            "fc1": init.linear(d, f, lead=lead),
            "fc2": init.linear(f, d, lead=lead),
            "mlp_ln": init.layer_norm(d, lead),
        },
    }
    if cfg.do_layer_norm_before:
        params["final_ln"] = init.layer_norm(d)
    if cfg.word_embed_proj_dim != cfg.hidden_size:
        params["project_in"] = init.linear(cfg.word_embed_proj_dim, d,
                                           bias=False)
        params["project_out"] = init.linear(d, cfg.word_embed_proj_dim,
                                            bias=False)
    return params


def resize_embeddings(params, new_vocab: int, init: nn.Init,
                      std: float = 0.02):
    """Grows the token-embedding table with N(0, std) rows (reference
    lm.resize_token_embeddings)."""
    w = params["embed_tokens"]["weight"]
    old_vocab, dim = w.shape
    if new_vocab <= old_vocab:
        return params
    new_rows = init.normal((new_vocab - old_vocab, dim), std).to(w.dtype)
    params = dict(params)
    params["embed_tokens"] = {"weight": torch.cat([w, new_rows], dim=0)}
    return params


def embed_tokens(params, ids):
    return params["embed_tokens"]["weight"][ids]


def init_cache(cfg: OPTConfig, batch: int, max_seq: int, *, device,
               dtype=torch.bfloat16):
    shape = (cfg.num_layers, batch, max_seq, cfg.num_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, device=device, dtype=dtype),
            "v": torch.zeros(shape, device=device, dtype=dtype)}


def _layer(cfg: OPTConfig, lp, h, *, cache_kv=None, cache_pos=None):
    b, t, d = h.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    pre_ln = cfg.do_layer_norm_before

    resid = h
    x = nn.layer_norm(lp["attn_ln"], h, cfg.layer_norm_eps) if pre_ln else h
    q = nn.linear(lp["attn"]["q"], x).reshape(b, t, nh, hd)
    k = nn.linear(lp["attn"]["k"], x).reshape(b, t, nh, hd)
    v = nn.linear(lp["attn"]["v"], x).reshape(b, t, nh, hd)

    if cache_kv is None:
        attn = dot_product_attention(q, k, v, causal=True)
    else:
        ck, cv = cache_kv
        if cache_pos == 0:
            attn = dot_product_attention(q, k, v, causal=True)
            ck[:, :t] = k
            cv[:, :t] = v
        elif t == 1:
            attn = dot_product_attention(
                q, ck[:, :cache_pos], cv[:, :cache_pos], causal=True,
                kv_offset=cache_pos - 1, extra_kv=(k, v))
            ck[:, cache_pos] = k[:, 0]
            cv[:, cache_pos] = v[:, 0]
        else:
            ck[:, cache_pos:cache_pos + t] = k
            cv[:, cache_pos:cache_pos + t] = v
            attn = dot_product_attention(q, ck, cv, causal=True,
                                         kv_offset=cache_pos)

    h = resid + nn.linear(lp["attn"]["o"], attn.reshape(b, t, d))
    if not pre_ln:
        h = nn.layer_norm(lp["attn_ln"], h, cfg.layer_norm_eps)
    resid = h
    x = nn.layer_norm(lp["mlp_ln"], h, cfg.layer_norm_eps) if pre_ln else h
    h = resid + nn.linear(lp["fc2"], torch.relu(nn.linear(lp["fc1"], x)))
    if not pre_ln:
        h = nn.layer_norm(lp["mlp_ln"], h, cfg.layer_norm_eps)
    return h


def forward(params, cfg: OPTConfig, inputs_embeds, *,
            collect_hidden: bool = False, cache=None, cache_pos=None,
            lm_head=None, skip_logits: bool = False):
    """Decoder forward from input embeddings (B, T, word_embed_proj_dim).

    Returns "last_hidden" (B, T, E); "logits" (B, T, V) in fp32 unless
    skip_logits; "hidden_states" (L+1, B, T, D) when collect_hidden (index
    0 = embedding stream, i = layer i's output); "cache" when given."""
    t = inputs_embeds.shape[1]
    dev = inputs_embeds.device
    h = inputs_embeds
    if "project_in" in params:
        h = nn.linear(params["project_in"], h)
    positions = torch.arange(t, device=dev)[None, :] + (cache_pos or 0)
    pos_emb = params["embed_positions"]["weight"][positions + cfg.position_offset]
    h = h + pos_emb.to(h.dtype)
    hs = [h] if collect_hidden else None

    layers = params["layers"]
    for i in range(cfg.num_layers):
        kv = None if cache is None else (cache["k"][i], cache["v"][i])
        h = _layer(cfg, nn.layer_view(layers, i), h, cache_kv=kv,
                   cache_pos=cache_pos)
        if collect_hidden:
            hs.append(h)

    if cfg.do_layer_norm_before:
        h = nn.layer_norm(params["final_ln"], h, cfg.layer_norm_eps)
    if "project_out" in params:
        h = nn.linear(params["project_out"], h)

    out = {"last_hidden": h}
    if not skip_logits:
        head = params["embed_tokens"]["weight"] if lm_head is None else lm_head
        # fp32 products of the input-dtype values, fp32 accumulation (the
        # JAX dot_general with preferred_element_type=float32)
        out["logits"] = torch.matmul(h.float(), head.float().t())
    if collect_hidden:
        out["hidden_states"] = torch.stack(hs)
    if cache is not None:
        out["cache"] = cache
    return out
