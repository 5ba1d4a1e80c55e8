"""Component-level timing of the SD v1.5 UNet denoise step on one card.

Port of scripts/profile_sd.py. Times each building block (self-attn,
cross-attn, GEGLU FF, the whole spatial transformer, resnet) at every UNet
resolution with the CFG batch of 4 images (8), as the port's UNet runs
them (models/sd/unet.py: the flash and GEGLU kernels on CUDA), then the
full UNet call with zero weights. Component rows are device ms (CUDA
events, the delta between two call counts). A full UNet call issues
thousands of launches, which the host cannot get ahead of, so it prints
two numbers: host-clock ms a call and the device-busy ms of one call
under torch.profiler.

    python -m gill_tpu_torch.scripts.profile_sd [--out PATH]
"""

from __future__ import annotations

import contextlib
import sys

import torch

from gill_tpu_torch.config import UNetConfig
from gill_tpu_torch.models.sd import unet as unet_mod
from gill_tpu_torch.nn import core as nn
from gill_tpu_torch.scripts._timing import (clock_note, delta_ms,
                                            host_and_device_ms, probe_main)

# (hw, ch, transformer layers at this resolution): SD v1.5 at 512^2,
# 64x64/320 -> 5 tfm blocks, 32x32/640 -> 5, 16x16/1280 -> 5, mid 8x8 -> 1
RESOLUTIONS = [(64, 320, 5), (32, 640, 5), (16, 1280, 5), (8, 1280, 1)]
BATCH = 2 * 4   # CFG batch for 4 images


def zero_unet(cfg: UNetConfig, device, seed: int = 0):
    """The full UNet tree in bf16 with every weight zero (the script's
    `jnp.zeros` tree)."""
    g = torch.Generator(device).manual_seed(seed)
    params = unet_mod.init(nn.Init(g, device, torch.bfloat16), cfg)
    return nn.tree_map(torch.zeros_like, params)


@contextlib.contextmanager
def patched(name: str, value):
    """unet_mod.<name> = value inside the block, the original after it,
    also when the block raises."""
    orig = getattr(unet_mod, name)
    setattr(unet_mod, name, value)
    try:
        yield
    finally:
        setattr(unet_mod, name, orig)


def unet_inputs(cfg: UNetConfig, batch: int, hw: int, device, seed: int = 0):
    """(latents, timesteps, context): zero latents at 500, random text
    states, as the script makes them."""
    g = torch.Generator(device).manual_seed(seed)
    ctx = torch.randn(batch, 77, cfg.cross_attention_dim, device=device,
                      generator=g).to(torch.bfloat16)
    lat = torch.zeros(batch, hw, hw, cfg.in_channels, device=device,
                      dtype=torch.bfloat16)
    return lat, torch.full((batch,), 500, device=device), ctx


def components(resolutions, cfg: UNetConfig, batch: int, device, n1, n2):
    """Prints and returns the component rows of every resolution."""
    g = torch.Generator(device).manual_seed(0)
    init = nn.Init(g, device, torch.bfloat16)
    ctx = torch.randn(batch, 77, cfg.cross_attention_dim, device=device,
                      generator=g).to(torch.bfloat16)
    nh, groups = cfg.num_heads, cfg.norm_groups
    rows, accounted = [], 0.0
    print(f"{'component':<34}{'ms':>9}{'ms*layers':>11}", flush=True)
    for hw, ch, nlayers in resolutions:
        s = hw * hw
        x = (torch.randn(batch, s, ch, device=device, generator=g) * 0.02
             ).to(torch.bfloat16)
        ximg = x.reshape(batch, hw, hw, ch)
        p_tfm = unet_mod._init_spatial_tfm(init, ch, cfg.cross_attention_dim)
        p_res = unet_mod._init_resnet(init, ch, ch, cfg.time_embed_dim)
        temb = torch.randn(batch, cfg.time_embed_dim, device=device,
                           generator=g).to(torch.bfloat16)
        blk = p_tfm["block"]

        def timed(fn):
            return delta_ms(fn, device, n1, n2)

        t_self = timed(lambda: unet_mod._attention(blk["attn1"], x, None, nh,
                                                   blk["ln1"]))
        t_cross = timed(lambda: unet_mod._attention(blk["attn2"], x, ctx, nh,
                                                    blk["ln2"]))
        t_ff = timed(lambda: unet_mod._geglu_ff(blk, x, blk["ln3"]))
        t_tfm = timed(lambda: unet_mod._spatial_tfm(p_tfm, ximg, ctx, nh,
                                                    groups, False))
        t_res = timed(lambda: unet_mod._resnet(p_res, ximg, temb, groups))
        n_res = nlayers + (2 if hw == 8 else 0)
        for name, t, mult in [
                (f"{hw}x{hw}/{ch} self-attn(S={s})", t_self, nlayers),
                (f"{hw}x{hw}/{ch} cross-attn", t_cross, nlayers),
                (f"{hw}x{hw}/{ch} geglu-ff", t_ff, nlayers),
                (f"{hw}x{hw}/{ch} spatial_tfm total", t_tfm, nlayers),
                (f"{hw}x{hw}/{ch} resnet", t_res, n_res)]:
            rows.append({"component": name, "ms": t, "ms_x_layers": t * mult})
            print(f"{name:<34}{t:>9.3f}{t * mult:>11.3f}", flush=True)
        accounted += (t_tfm + t_res) * nlayers
        print(flush=True)
    return rows, accounted


def profile(resolutions=RESOLUTIONS, cfg=None, batch=BATCH, device="cuda",
            n1=2, n2=12, unet_reps=3):
    print(clock_note(device), flush=True)
    cfg = cfg or UNetConfig()
    with torch.no_grad():
        rows, accounted = components(resolutions, cfg, batch, device, n1, n2)
        params = zero_unet(cfg, device)
        lat, ts, ctx = unet_inputs(cfg, batch, resolutions[0][0], device)
        host, busy = host_and_device_ms(
            lambda: unet_mod.apply(params, cfg, lat, ts, ctx), device,
            unet_reps)
    rows.append({"component": "FULL UNET step", "batch": batch,
                 "host_ms": host, "device_busy_ms": busy,
                 "img_s_at_50_steps": (batch // 2) / (50 * host / 1e3)})
    busy_s = "not measured" if busy is None else f"{busy:.3f}"
    print(f"{f'FULL UNET step (CFG batch {batch}) host':<34}{host:>9.3f}")
    print(f"{'  device-busy ms (profiler)':<34}{busy_s:>9}")
    print(f"{'  -> img/s @50 steps, host clock':<34}"
          f"{rows[-1]['img_s_at_50_steps']:>9.3f}")
    print(f"{'accounted tfm+res (approx)':<34}{accounted:>9.3f}", flush=True)
    return rows


def main(argv=None, device="cuda", **kw) -> int:
    return probe_main(profile, __doc__, argv, device, **kw)


if __name__ == "__main__":
    sys.exit(main())
