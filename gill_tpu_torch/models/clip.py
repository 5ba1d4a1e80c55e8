"""CLIP towers (vision ViT + text encoder) over explicit parameter trees.

Counterpart of gill_tpu/models/clip.py. Vision: HF `CLIPVisionModel`, of
which GILL consumes only `pooler_output` (post-LayerNorm over [CLS]).
Text: HF `CLIPTextModel` (causal, quick_gelu, final LayerNorm), the SD
prompt encoder. Layer weights are stacked along a leading L axis as in
gill_tpu; the layers run as a Python loop over views of the stack. The
257-token vision attention takes the flash kernel on CUDA through
ops.attention's dispatcher.
"""

from __future__ import annotations

import torch

from gill_tpu_torch.config import CLIPTextConfig, CLIPVisionConfig
from gill_tpu_torch.nn import core as nn
from gill_tpu_torch.ops.attention import dot_product_attention


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _init_layers(init: nn.Init, n: int, d: int, inter: int):
    lead = (n,)
    return {
        "ln1": init.layer_norm(d, lead),
        "attn": init.mha(d, lead=lead),
        "ln2": init.layer_norm(d, lead),
        "fc1": init.linear(d, inter, lead=lead),
        "fc2": init.linear(inter, d, lead=lead),
    }


def _encoder_layer(lp, h, *, num_heads: int, causal: bool, eps: float):
    b, t, d = h.shape
    hd = d // num_heads
    resid = h
    x = nn.layer_norm(lp["ln1"], h, eps)
    q = nn.linear(lp["attn"]["q"], x).reshape(b, t, num_heads, hd)
    k = nn.linear(lp["attn"]["k"], x).reshape(b, t, num_heads, hd)
    v = nn.linear(lp["attn"]["v"], x).reshape(b, t, num_heads, hd)
    a = dot_product_attention(q, k, v, causal=causal)
    h = resid + nn.linear(lp["attn"]["o"], a.reshape(b, t, d))
    resid = h
    x = nn.layer_norm(lp["ln2"], h, eps)
    x = nn.linear(lp["fc2"], quick_gelu(nn.linear(lp["fc1"], x)))
    return resid + x


def _encoder(layers, h, *, num_heads: int, causal: bool, eps: float):
    for i in range(layers["ln1"]["scale"].shape[0]):
        h = _encoder_layer(nn.layer_view(layers, i), h, num_heads=num_heads,
                           causal=causal, eps=eps)
    return h


# ---------------------------------------------------------------------------
# vision tower
# ---------------------------------------------------------------------------

def init_vision(init: nn.Init, cfg: CLIPVisionConfig):
    d, p = cfg.hidden_size, cfg.patch_size
    return {
        "class_embedding": init.normal((d,), 0.02),
        # HWIO (p, p, 3, d) in gill_tpu -> OIHW view in channels_last memory
        "patch_embedding": {"w": init.normal((d, p, p, 3), 0.02)
                            .permute(0, 3, 1, 2)},
        "position_embedding": init.embedding(cfg.seq_len, d),
        "pre_ln": init.layer_norm(d),
        "layers": _init_layers(init, cfg.num_layers, d, cfg.intermediate_size),
        "post_ln": init.layer_norm(d),
    }


def vision_forward(params, cfg: CLIPVisionConfig, pixel_values):
    """pixel_values: (B, H, W, 3) NHWC, CLIP-normalized. Returns
    "last_hidden" (B, 1+P, D) and "pooler_output" (B, D)."""
    b = pixel_values.shape[0]
    patches = nn.conv2d(params["patch_embedding"], pixel_values,
                        stride=cfg.patch_size, padding="VALID")
    patches = patches.reshape(b, -1, cfg.hidden_size)
    cls = params["class_embedding"].to(patches.dtype)[None, None].expand(
        b, 1, cfg.hidden_size)
    h = torch.cat([cls, patches], dim=1)
    h = h + params["position_embedding"]["weight"].to(h.dtype)[None]
    h = nn.layer_norm(params["pre_ln"], h, cfg.layer_norm_eps)
    h = _encoder(params["layers"], h, num_heads=cfg.num_heads, causal=False,
                 eps=cfg.layer_norm_eps)
    pooled = nn.layer_norm(params["post_ln"], h[:, 0], cfg.layer_norm_eps)
    return {"last_hidden": h, "pooler_output": pooled}


def get_image_features(params, cfg: CLIPVisionConfig, pixel_values):
    """pooler_output -> CLIP's joint space through `visual_projection`
    (HF CLIPModel.get_image_features; the evals' similarity metric,
    reference evals/compute_clip_similarity_vist.py:40-51)."""
    if "visual_projection" not in params:
        raise KeyError("load full CLIP weights (with visual_projection) for "
                       "image features")
    pooled = vision_forward(params, cfg, pixel_values)["pooler_output"]
    return nn.linear(params["visual_projection"], pooled)


# ---------------------------------------------------------------------------
# text tower
# ---------------------------------------------------------------------------

def init_text(init: nn.Init, cfg: CLIPTextConfig):
    d = cfg.hidden_size
    return {
        "token_embedding": init.embedding(cfg.vocab_size, d),
        "position_embedding": init.embedding(cfg.max_positions, d),
        "layers": _init_layers(init, cfg.num_layers, d, cfg.intermediate_size),
        "final_ln": init.layer_norm(d),
    }


def text_forward(params, cfg: CLIPTextConfig, input_ids):
    """input_ids: (B, T). Returns "last_hidden" (B, T, D) and
    "pooler_output" (B, D) at the first EOT position. The causal attention
    goes through the dispatcher, whose causal rule takes a CUDA prompt to
    the flash kernel at any length (gill_tpu's >= 256-key gate keeps its
    77 tokens on the XLA path; the two compute the same function)."""
    t = input_ids.shape[1]
    h = params["token_embedding"]["weight"][input_ids]
    h = h + params["position_embedding"]["weight"][:t][None].to(h.dtype)
    h = _encoder(params["layers"], h, num_heads=cfg.num_heads, causal=True,
                 eps=cfg.layer_norm_eps)
    h = nn.layer_norm(params["final_ln"], h, cfg.layer_norm_eps)
    eot = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
    pooled = h[torch.arange(h.shape[0], device=h.device), eot]
    return {"last_hidden": h, "pooler_output": pooled}
