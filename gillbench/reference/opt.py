"""OPT decoder, plain fp32 (pre-LayerNorm, ReLU MLP, learned positions at an
offset of 2, tied head), one full causal forward a prompt, one layer's
weights in fp32 at a time.
"""

from __future__ import annotations

import torch

from gillbench.reference import layers as L

def _layer(lp, h, heads, eps):
    b, t, d = h.shape
    hd = d // heads
    x = L.layer_norm(lp["attn_ln"], h, eps)
    a = lp["attn"]
    q = L.linear(a["q"], x).reshape(b, t, heads, hd)
    k = L.linear(a["k"], x).reshape(b, t, heads, hd)
    v = L.linear(a["v"], x).reshape(b, t, heads, hd)
    o = L.attention(q, k, v, causal=True).reshape(b, t, d)
    h = h + L.linear(a["o"], o)
    x = L.layer_norm(lp["mlp_ln"], h, eps)
    x = torch.relu(L.linear(lp["fc1"], x))
    return h + L.linear(lp["fc2"], x)


def forward(params, cfg: dict, embeds):
    """embeds (1, T, E) fp32 -> the final-LayerNorm hidden states (1, T, E).
    cfg: the configuration file's "opt" group."""
    t = embeds.shape[1]
    pos = params["embed_positions"]["weight"][
        torch.arange(t, device=embeds.device) + 2].float()
    h = embeds.float() + pos[None]
    eps = cfg.get("layer_norm_eps", 1e-5)
    for i in range(cfg["num_hidden_layers"]):
        h = _layer(L.layer(params["layers"], i), h,
                   cfg["num_attention_heads"], eps)
    return L.layer_norm(params["final_ln"], h, eps)

