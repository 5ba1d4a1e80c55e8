"""Stable Diffusion v1.5 UNet (UNet2DConditionModel) over explicit
parameter trees, NHWC activations.

Counterpart of gill_tpu/models/sd/unet.py: 4 -> 4 channels, blocks
(320, 640, 1280, 1280), 2 layers per block, cross-attention on 77 x 768
text states, 8 heads; down (CrossAttn x3 + plain) / mid (res-attn-res) /
up (plain + CrossAttn x3).

On CUDA, attention over >= 64 spatial tokens (self and the 77-token
cross-attention) runs the flash kernel at the TRUE head dim (40/80/160),
and every transformer feed-forward runs the fused GEGLU kernel. gill_tpu's
TPU-only knobs (128-lane head padding of the projections, SUM_LANE,
OPROJ_SLICE, FUSE_LN) and the int8 modes are not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gill_tpu_torch.config import UNetConfig
from gill_tpu_torch.nn import core as nn
from gill_tpu_torch.ops.attention import dot_product_attention
from gill_tpu_torch.ops.geglu import geglu_ff


def timestep_embedding(timesteps, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0, max_period: float = 10000.0):
    """Sinusoidal embedding (diffusers get_timestep_embedding)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_resnet(init: nn.Init, in_ch, out_ch, temb_dim):
    p = {"norm1": init.group_norm(in_ch),
         "conv1": init.conv2d(in_ch, out_ch, 3),
         "norm2": init.group_norm(out_ch),
         "conv2": init.conv2d(out_ch, out_ch, 3)}
    if temb_dim:
        p["time_emb"] = init.linear(temb_dim, out_ch)
    if in_ch != out_ch:
        p["shortcut"] = init.conv2d(in_ch, out_ch, 1)
    return p


def _init_attn_proj(init: nn.Init, dim, ctx_dim):
    return {"q": init.linear(dim, dim, bias=False),
            "k": init.linear(ctx_dim, dim, bias=False),
            "v": init.linear(ctx_dim, dim, bias=False),
            "o": init.linear(dim, dim)}


def _init_spatial_tfm(init: nn.Init, ch, ctx_dim):
    return {
        "norm": init.group_norm(ch),
        "proj_in": init.conv2d(ch, ch, 1),
        "block": {"ln1": init.layer_norm(ch),
                  "attn1": _init_attn_proj(init, ch, ch),
                  "ln2": init.layer_norm(ch),
                  "attn2": _init_attn_proj(init, ch, ctx_dim),
                  "ln3": init.layer_norm(ch),
                  "geglu": init.linear(ch, ch * 8),
                  "ff_out": init.linear(ch * 4, ch)},
        "proj_out": init.conv2d(ch, ch, 1),
    }


def init(init: nn.Init, cfg: UNetConfig):
    ch0, temb = cfg.block_out_channels[0], cfg.time_embed_dim
    params = {
        "conv_in": init.conv2d(cfg.in_channels, ch0, 3),
        "time_fc1": init.linear(ch0, temb),
        "time_fc2": init.linear(temb, temb),
        "down": [], "up": [],
        "norm_out": init.group_norm(ch0),
        "conv_out": init.conv2d(ch0, cfg.out_channels, 3),
    }
    out_ch = ch0
    for i, btype in enumerate(cfg.down_block_types):
        in_ch, out_ch = out_ch, cfg.block_out_channels[i]
        block = {"resnets": [], "attns": []}
        for j in range(cfg.layers_per_block):
            block["resnets"].append(_init_resnet(
                init, in_ch if j == 0 else out_ch, out_ch, temb))
            if btype == "CrossAttnDownBlock2D":
                block["attns"].append(_init_spatial_tfm(
                    init, out_ch, cfg.cross_attention_dim))
        if i < len(cfg.down_block_types) - 1:
            block["downsample"] = init.conv2d(out_ch, out_ch, 3)
        params["down"].append(block)

    mid_ch = cfg.block_out_channels[-1]
    params["mid"] = {
        "res1": _init_resnet(init, mid_ch, mid_ch, temb),
        "attn": _init_spatial_tfm(init, mid_ch, cfg.cross_attention_dim),
        "res2": _init_resnet(init, mid_ch, mid_ch, temb),
    }

    rev = list(reversed(cfg.block_out_channels))
    prev_ch = mid_ch
    for i, btype in enumerate(cfg.up_block_types):
        out_ch = rev[i]
        skip_in_ch = rev[min(i + 1, len(rev) - 1)]
        block = {"resnets": [], "attns": []}
        for j in range(cfg.layers_per_block + 1):
            res_skip = skip_in_ch if j == cfg.layers_per_block else out_ch
            res_in = prev_ch if j == 0 else out_ch
            block["resnets"].append(_init_resnet(
                init, res_in + res_skip, out_ch, temb))
            if btype == "CrossAttnUpBlock2D":
                block["attns"].append(_init_spatial_tfm(
                    init, out_ch, cfg.cross_attention_dim))
        if i < len(cfg.up_block_types) - 1:
            block["upsample"] = init.conv2d(out_ch, out_ch, 3)
        params["up"].append(block)
        prev_ch = out_ch
    return params


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _resnet(p, x, temb, groups: int):
    h = nn.group_norm(p["norm1"], x, groups, eps=1e-5)
    h = nn.conv2d(p["conv1"], F.silu(h), padding=1)
    if "time_emb" in p and temb is not None:
        h = h + nn.linear(p["time_emb"], F.silu(temb))[:, None, None, :]
    h = nn.group_norm(p["norm2"], h, groups, eps=1e-5)
    h = nn.conv2d(p["conv2"], F.silu(h), padding=1)
    if "shortcut" in p:
        x = nn.conv2d(p["shortcut"], x, padding=0)
    return x + h


def _attention(p, x, ctx, num_heads: int, ln):
    """Pre-LayerNorm attention; ctx None = self-attention over the
    normalized x. On CUDA, >= 64 query tokens force the flash kernel, the
    77-key cross-attention included (gill_tpu's impl='flash' gate)."""
    b, t, d = x.shape
    hd = d // num_heads
    x = nn.layer_norm(ln, x, 1e-5)
    ctx = x if ctx is None else ctx
    s = ctx.shape[1]
    q = nn.linear(p["q"], x).reshape(b, t, num_heads, hd)
    k = nn.linear(p["k"], ctx).reshape(b, s, num_heads, hd)
    v = nn.linear(p["v"], ctx).reshape(b, s, num_heads, hd)
    impl = "flash" if (x.is_cuda and t >= 64) else "auto"
    o = dot_product_attention(q, k, v, causal=False, fast=True, impl=impl)
    return nn.linear(p["o"], o.reshape(b, t, d))


def _geglu_ff(p, h, ln):
    """GEGLU feed-forward after the block's third LayerNorm: the fused
    kernel on CUDA, the composed ops (exact-erf gelu) on the CPU."""
    h = nn.layer_norm(ln, h, 1e-5)
    return geglu_ff(h, p["geglu"]["w"].to(h.dtype), p["geglu"]["b"].to(h.dtype),
                    p["ff_out"]["w"].to(h.dtype), p["ff_out"]["b"].to(h.dtype))


def _tfm_block(p, x, ctx, num_heads: int):
    x = x + _attention(p["attn1"], x, None, num_heads, p["ln1"])
    x = x + _attention(p["attn2"], x, ctx, num_heads, p["ln2"])
    return x + _geglu_ff(p, x, p["ln3"])


def _spatial_tfm(p, x, ctx, num_heads: int, groups: int):
    b, h, w, c = x.shape
    y = nn.group_norm(p["norm"], x, groups, eps=1e-6)
    y = nn.conv2d(p["proj_in"], y, padding=0).reshape(b, h * w, c)
    y = _tfm_block(p["block"], y, ctx, num_heads).reshape(b, h, w, c)
    return nn.conv2d(p["proj_out"], y, padding=0) + x


def upsample_nearest2x(x):
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


def apply(params, cfg: UNetConfig, latents, timesteps, encoder_hidden_states):
    """latents (B, H, W, 4) NHWC; timesteps (B,) or scalar; encoder states
    (B, 77, 768). Returns the predicted noise (B, H, W, 4)."""
    x = latents
    timesteps = torch.as_tensor(timesteps, device=x.device)
    if timesteps.ndim == 0:
        timesteps = timesteps.expand(x.shape[0])
    temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                              cfg.flip_sin_to_cos, cfg.freq_shift)
    temb = nn.linear(params["time_fc2"], F.silu(
        nn.linear(params["time_fc1"], temb.to(x.dtype))))
    ctx = encoder_hidden_states.to(x.dtype)
    g, nh = cfg.norm_groups, cfg.num_heads

    x = nn.conv2d(params["conv_in"], x, padding=1)
    skips = [x]
    for block in params["down"]:
        for j, res in enumerate(block["resnets"]):
            x = _resnet(res, x, temb, g)
            if block["attns"]:
                x = _spatial_tfm(block["attns"][j], x, ctx, nh, g)
            skips.append(x)
        if "downsample" in block:
            x = nn.conv2d(block["downsample"], x, stride=2, padding=1)
            skips.append(x)

    x = _resnet(params["mid"]["res1"], x, temb, g)
    x = _spatial_tfm(params["mid"]["attn"], x, ctx, nh, g)
    x = _resnet(params["mid"]["res2"], x, temb, g)

    for block in params["up"]:
        for j, res in enumerate(block["resnets"]):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = _resnet(res, x, temb, g)
            if block["attns"]:
                x = _spatial_tfm(block["attns"][j], x, ctx, nh, g)
        if "upsample" in block:
            x = nn.conv2d(block["upsample"], upsample_nearest2x(x), padding=1)

    x = nn.group_norm(params["norm_out"], x, g, eps=1e-5)
    return nn.conv2d(params["conv_out"], F.silu(x), padding=1)
