"""Stable Diffusion VAE (AutoencoderKL) over explicit parameter trees,
NHWC (counterpart of gill_tpu/models/sd/vae.py).

SD v1.5: block channels (128, 256, 512, 512), 2 resnets per encoder block
and 3 per decoder block, one single-head attention over all 64 x 64
latent positions at each bottleneck (its 512-wide head runs the flash
kernel on CUDA, exact softmax), GroupNorm(32, eps 1e-6), silu. The
encoder downsamples as diffusers does: pad one row and column at the
bottom and right, then a stride-2 VALID conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gill_tpu_torch.config import VAEConfig
from gill_tpu_torch.models.sd.unet import upsample_nearest2x
from gill_tpu_torch.nn import core as nn
from gill_tpu_torch.ops.attention import dot_product_attention

SCALING_FACTOR = 0.18215


def _init_resnet(init: nn.Init, in_ch, out_ch):
    p = {"norm1": init.group_norm(in_ch),
         "conv1": init.conv2d(in_ch, out_ch, 3),
         "norm2": init.group_norm(out_ch),
         "conv2": init.conv2d(out_ch, out_ch, 3)}
    if in_ch != out_ch:
        p["shortcut"] = init.conv2d(in_ch, out_ch, 1)
    return p


def init_decoder(init: nn.Init, cfg: VAEConfig):
    rev = list(reversed(cfg.block_out_channels))
    ch = rev[0]
    params = {
        "post_quant_conv": init.conv2d(cfg.latent_channels,
                                       cfg.latent_channels, 1),
        "conv_in": init.conv2d(cfg.latent_channels, ch, 3),
        "mid": {"res1": _init_resnet(init, ch, ch),
                "attn": {"norm": init.group_norm(ch),
                         **{k: init.linear(ch, ch) for k in "qkvo"}},
                "res2": _init_resnet(init, ch, ch)},
        "up": [],
        "norm_out": init.group_norm(rev[-1]),
        "conv_out": init.conv2d(rev[-1], cfg.in_channels, 3),
    }
    prev = ch
    for i, out_ch in enumerate(rev):
        block = {"resnets": [_init_resnet(init, prev if j == 0 else out_ch,
                                          out_ch)
                             for j in range(cfg.layers_per_block + 1)]}
        if i < len(rev) - 1:
            block["upsample"] = init.conv2d(out_ch, out_ch, 3)
        params["up"].append(block)
        prev = out_ch
    return params


def init_encoder(init: nn.Init, cfg: VAEConfig):
    chans = cfg.block_out_channels
    ch = chans[-1]
    params = {
        "conv_in": init.conv2d(cfg.in_channels, chans[0], 3),
        "down": [],
        "mid": {"res1": _init_resnet(init, ch, ch),
                "attn": {"norm": init.group_norm(ch),
                         **{k: init.linear(ch, ch) for k in "qkvo"}},
                "res2": _init_resnet(init, ch, ch)},
        "norm_out": init.group_norm(ch),
        "conv_out": init.conv2d(ch, 2 * cfg.latent_channels, 3),
        "quant_conv": init.conv2d(2 * cfg.latent_channels,
                                  2 * cfg.latent_channels, 1),
    }
    prev = chans[0]
    for i, out_ch in enumerate(chans):
        block = {"resnets": [_init_resnet(init, prev if j == 0 else out_ch,
                                          out_ch)
                             for j in range(cfg.layers_per_block)]}
        if i < len(chans) - 1:
            block["downsample"] = init.conv2d(out_ch, out_ch, 3)
        params["down"].append(block)
        prev = out_ch
    return params


def _resnet(p, x, groups):
    h = nn.group_norm(p["norm1"], x, groups, eps=1e-6)
    h = nn.conv2d(p["conv1"], F.silu(h), padding=1)
    h = nn.group_norm(p["norm2"], h, groups, eps=1e-6)
    h = nn.conv2d(p["conv2"], F.silu(h), padding=1)
    if "shortcut" in p:
        x = nn.conv2d(p["shortcut"], x, padding=0)
    return x + h


def _attn(p, x, groups):
    """Single-head self-attention over all spatial positions, exact
    softmax (fast=False: the VAE's q/k are not LayerNorm-bounded)."""
    b, h, w, c = x.shape
    y = nn.group_norm(p["norm"], x, groups, eps=1e-6).reshape(b, h * w, c)
    q = nn.linear(p["q"], y)[:, :, None, :]
    k = nn.linear(p["k"], y)[:, :, None, :]
    v = nn.linear(p["v"], y)[:, :, None, :]
    a = dot_product_attention(q, k, v, causal=False, fast=False)[:, :, 0, :]
    return x + nn.linear(p["o"], a).reshape(b, h, w, c)


def decode(params, cfg: VAEConfig, latents, scale: bool = True):
    """latents (B, h, w, 4) -> images (B, 8h, 8w, 3) in [-1, 1]."""
    g = cfg.norm_groups
    x = latents / SCALING_FACTOR if scale else latents
    x = nn.conv2d(params["post_quant_conv"], x, padding=0)
    x = nn.conv2d(params["conv_in"], x, padding=1)
    x = _resnet(params["mid"]["res1"], x, g)
    x = _attn(params["mid"]["attn"], x, g)
    x = _resnet(params["mid"]["res2"], x, g)
    for block in params["up"]:
        for res in block["resnets"]:
            x = _resnet(res, x, g)
        if "upsample" in block:
            x = nn.conv2d(block["upsample"], upsample_nearest2x(x), padding=1)
    x = nn.group_norm(params["norm_out"], x, g, eps=1e-6)
    return nn.conv2d(params["conv_out"], F.silu(x), padding=1)


def encode_moments(params, cfg: VAEConfig, images):
    """images (B, H, W, 3) in [-1, 1] -> the posterior's unscaled (mean,
    logvar), each (B, H/8, W/8, 4)."""
    g = cfg.norm_groups
    x = nn.conv2d(params["conv_in"], images, padding=1)
    for block in params["down"]:
        for res in block["resnets"]:
            x = _resnet(res, x, g)
        if "downsample" in block:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
            x = nn.conv2d(block["downsample"], x, stride=2, padding="VALID")
    x = _resnet(params["mid"]["res1"], x, g)
    x = _attn(params["mid"]["attn"], x, g)
    x = _resnet(params["mid"]["res2"], x, g)
    x = nn.group_norm(params["norm_out"], x, g, eps=1e-6)
    x = nn.conv2d(params["conv_out"], F.silu(x), padding=1)
    x = nn.conv2d(params["quant_conv"], x, padding=0)
    mean, logvar = x.chunk(2, dim=-1)
    return mean, logvar


def encode(params, cfg: VAEConfig, images, generator=None,
           sample: bool = False):
    """images (B, H, W, 3) in [-1, 1] -> latents (B, H/8, W/8, 4), scaled:
    the posterior's mean, or with `sample` a draw from it (the noise from
    `generator`, on the images' device)."""
    if sample and generator is None:
        raise ValueError("sample=True needs a generator")
    mean, logvar = encode_moments(params, cfg, images)
    if sample:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
        mean = mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * noise
    return mean * SCALING_FACTOR
