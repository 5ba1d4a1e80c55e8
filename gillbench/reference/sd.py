"""Stable Diffusion v1.5 in plain fp32: the UNet (UNet2DConditionModel), the
PNDM (PLMS) sampler as SD v1.5 configures it, and the VAE decoder. NHWC
activations, the port's parameter layout. Classifier-free guidance runs
the UNet on [unconditional, conditional] rows, the unconditional states
being zeros (the pipeline's rule when it has no text encoder)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gillbench.reference import layers as L

VAE_SCALE = 0.18215


def _temb(t, dim):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    e = freqs[None] * t.float()[:, None]
    return torch.cat([torch.cos(e), torch.sin(e)], -1)   # flip_sin_to_cos


def _resnet(p, x, temb, groups, eps):
    h = L.conv2d(p["conv1"], F.silu(L.group_norm(p["norm1"], x, groups, eps)))
    if temb is not None and "time_emb" in p:
        h = h + L.linear(p["time_emb"], F.silu(temb))[:, None, None, :]
    h = L.conv2d(p["conv2"], F.silu(L.group_norm(p["norm2"], h, groups, eps)))
    if "shortcut" in p:
        x = L.conv2d(p["shortcut"], x, padding=0)
    return x + h


def _spatial(p, x, ctx, heads, groups):
    b, h, w, c = x.shape
    y = L.conv2d(p["proj_in"], L.group_norm(p["norm"], x, groups, 1e-6),
                 padding=0).reshape(b, h * w, c)
    blk = p["block"]
    y = y + L.mha(blk["attn1"], L.layer_norm(blk["ln1"], y, 1e-5), None,
                  heads)
    y = y + L.mha(blk["attn2"], L.layer_norm(blk["ln2"], y, 1e-5), ctx, heads)
    z = L.linear(blk["geglu"], L.layer_norm(blk["ln3"], y, 1e-5))
    val, gate = z.chunk(2, dim=-1)
    y = y + L.linear(blk["ff_out"], val * F.gelu(gate))
    return L.conv2d(p["proj_out"], y.reshape(b, h, w, c), padding=0) + x


def _up2(x):
    return x.repeat_interleave(2, 1).repeat_interleave(2, 2)


def unet(params, cfg: dict, lat, t, ctx):
    """Predicted noise (B, H, W, 4) of NHWC latents at timestep t."""
    g, heads = cfg["norm_num_groups"], cfg["attention_head_dim"]
    ch0 = cfg["block_out_channels"][0]
    tt = torch.full((lat.shape[0],), float(t), device=lat.device)
    temb = L.linear(params["time_fc2"], F.silu(
        L.linear(params["time_fc1"], _temb(tt, ch0))))
    x = L.conv2d(params["conv_in"], lat.float())
    skips = [x]
    for blk in params["down"]:
        for j, res in enumerate(blk["resnets"]):
            x = _resnet(res, x, temb, g, 1e-5)
            if blk["attns"]:
                x = _spatial(blk["attns"][j], x, ctx, heads, g)
            skips.append(x)
        if "downsample" in blk:
            x = L.conv2d(blk["downsample"], x, stride=2, padding=1)
            skips.append(x)
    mid = params["mid"]
    x = _resnet(mid["res1"], x, temb, g, 1e-5)
    x = _spatial(mid["attn"], x, ctx, heads, g)
    x = _resnet(mid["res2"], x, temb, g, 1e-5)
    for blk in params["up"]:
        for j, res in enumerate(blk["resnets"]):
            x = _resnet(res, torch.cat([x, skips.pop()], -1), temb, g, 1e-5)
            if blk["attns"]:
                x = _spatial(blk["attns"][j], x, ctx, heads, g)
        if "upsample" in blk:
            x = L.conv2d(blk["upsample"], _up2(x))
    x = F.silu(L.group_norm(params["norm_out"], x, g, 1e-5))
    return L.conv2d(params["conv_out"], x)


def _vae_attn(p, x, groups):
    b, h, w, c = x.shape
    y = L.group_norm(p["norm"], x, groups, 1e-6).reshape(b, h * w, c)
    q, k, v = (L.linear(p[n], y)[:, :, None, :] for n in "qkv")
    a = L.attention(q, k, v)[:, :, 0, :]
    return x + L.linear(p["o"], a).reshape(b, h, w, c)


def vae_decode(params, cfg: dict, lat):
    """Latents (B, h, w, 4) -> images (B, 8h, 8w, 3) in [0, 1]."""
    g = cfg["norm_num_groups"]
    x = L.conv2d(params["post_quant_conv"], lat.float() / VAE_SCALE,
                 padding=0)
    x = L.conv2d(params["conv_in"], x)
    x = _resnet(params["mid"]["res1"], x, None, g, 1e-6)
    x = _vae_attn(params["mid"]["attn"], x, g)
    x = _resnet(params["mid"]["res2"], x, None, g, 1e-6)
    for blk in params["up"]:
        for res in blk["resnets"]:
            x = _resnet(res, x, None, g, 1e-6)
        if "upsample" in blk:
            x = L.conv2d(blk["upsample"], _up2(x))
    x = F.silu(L.group_norm(params["norm_out"], x, g, 1e-6))
    img = L.conv2d(params["conv_out"], x)
    return torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)


class PNDM:
    """diffusers' PNDMScheduler with skip_prk_steps=True, scaled_linear betas
    0.00085 -> 0.012 over 1000 steps, steps_offset 1, set_alpha_to_one False
    (SD v1.5's scheduler_config.json): the PLMS steps in fp32."""

    def __init__(self, steps: int, train_steps: int = 1000,
                 beta0: float = 0.00085, beta1: float = 0.012):
        betas = torch.linspace(beta0 ** 0.5, beta1 ** 0.5, train_steps,
                               dtype=torch.float64) ** 2
        self.acp = torch.cumprod(1.0 - betas, 0)
        self.ratio = train_steps // steps
        ts = [i * self.ratio + 1 for i in range(steps)]
        self.timesteps = (ts[:-1] + ts[-2:-1] + ts[-1:])[::-1]

    def _prev(self, sample, t, prev_t, eps):
        a_t = float(self.acp[t])
        a_p = float(self.acp[prev_t]) if prev_t >= 0 else float(self.acp[0])
        b_t, b_p = 1.0 - a_t, 1.0 - a_p
        coeff = (a_p - a_t) / (a_t * b_p ** 0.5 + (a_t * b_t * a_p) ** 0.5)
        return (a_p / a_t) ** 0.5 * sample - coeff * eps

    def run(self, eps_fn, latents):
        """The PLMS loop: eps_fn(latents, t) -> noise prediction."""
        ets, cur = [], None
        x = latents
        for n, t in enumerate(self.timesteps):
            eps = eps_fn(x, t)
            if n == 1:
                blended = (eps + ets[0]) / 2.0
                x = self._prev(cur, t + self.ratio, t, blended)
                continue
            ets = [eps] + ets[:3]
            if len(ets) == 1:
                blended, cur = eps, x
            elif len(ets) == 2:
                blended = (3 * ets[0] - ets[1]) / 2
            elif len(ets) == 3:
                blended = (23 * ets[0] - 16 * ets[1] + 5 * ets[2]) / 12
            else:
                blended = (55 * ets[0] - 59 * ets[1] + 37 * ets[2]
                           - 9 * ets[3]) / 24
            x = self._prev(x, t, t - self.ratio, blended)
        return x


def generate(params, cfg: dict, ctx, latents, steps: int, guidance: float):
    """The CFG denoise of `latents` (B, h, w, 4) under conditioning ctx
    (B, 77, 768); returns the final latents."""
    neg = torch.zeros_like(ctx)
    cond = torch.cat([neg, ctx]).float()

    def eps_fn(x, t):
        e = unet(params, cfg, torch.cat([x, x]), t, cond)
        eu, et = e.chunk(2)
        return eu + guidance * (et - eu)

    return PNDM(steps).run(eps_fn, latents.float())
