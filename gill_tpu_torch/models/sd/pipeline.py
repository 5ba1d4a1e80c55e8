"""Stable Diffusion v1.5 text-to-image pipeline driven by prompt
embeddings (counterpart of gill_tpu/models/sd/pipeline.py).

`prompt_embeds` bypass the text encoder so GILLMapper outputs condition
the UNet directly (reference gill/custom_sd.py:265,489,594-604). With
guidance_scale > 1 the UNet runs on the CFG batch [uncond, cond]; the
unconditional embeddings are `negative_prompt_embeds` or zeros (the case
of gill_tpu's pipeline without an SD tokenizer). The 50-step PNDM loop is a
Python loop; the scheduler math runs in fp32 on fp32 latents, while the
UNet and the VAE run in their parameters' dtype. Latents come from an
explicit `torch.Generator` or are passed in.
"""

from __future__ import annotations

from typing import Optional

import torch

from gill_tpu_torch.config import SDPipelineConfig
from gill_tpu_torch.models.sd import unet as unet_mod
from gill_tpu_torch.models.sd import vae as vae_mod
from gill_tpu_torch.models.sd.scheduler import PNDMScheduler
from gill_tpu_torch.nn.core import tree_leaves


class StableDiffusionPipeline:
    def __init__(self, cfg: SDPipelineConfig, params: dict,
                 scheduler: Optional[PNDMScheduler] = None):
        """params: {"unet", "vae_decoder", optional "text_encoder"}."""
        self.cfg = cfg
        self.params = params
        self.scheduler = scheduler or PNDMScheduler(cfg.scheduler)
        self.latent_channels = cfg.vae.latent_channels

    def __call__(self, *, prompt_embeds, negative_prompt_embeds=None,
                 height: Optional[int] = None, width: Optional[int] = None,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 generator: Optional[torch.Generator] = None, latents=None,
                 output_latents: bool = False):
        """Returns images (B, H, W, 3) float32 in [0, 1] on the embeddings'
        device (or the final latents when output_latents)."""
        b = prompt_embeds.shape[0]
        dev = prompt_embeds.device
        if guidance_scale > 1.0:
            neg = negative_prompt_embeds
            if neg is None:
                neg = torch.zeros(
                    (b, self.cfg.text.max_positions,
                     self.cfg.unet.cross_attention_dim), device=dev)
            ctx = torch.cat([neg.to(prompt_embeds.dtype), prompt_embeds])
        else:
            ctx = prompt_embeds
        h = (height or self.cfg.default_size) // self.cfg.vae_scale
        w = (width or self.cfg.default_size) // self.cfg.vae_scale
        if latents is None:
            latents = torch.randn((b, h, w, self.latent_channels),
                                  generator=generator, device=dev)
        latents = latents.to(dev).float() * self.scheduler.init_noise_sigma
        latents = self.denoise(latents, ctx, num_inference_steps,
                               guidance_scale)
        if output_latents:
            return latents
        return self.decode_latents(latents)

    def denoise(self, latents, ctx, num_inference_steps: int,
                guidance_scale: float):
        ts, ratio = self.scheduler.timesteps(num_inference_steps)
        state = self.scheduler.init_state(latents)
        unet_params = self.params["unet"]
        unet_dtype = unet_params["conv_in"]["w"].dtype
        do_cfg = guidance_scale > 1.0
        ctx = ctx.to(unet_dtype)
        for t in ts:
            lat_in = torch.cat([latents, latents]) if do_cfg else latents
            t_dev = torch.tensor(float(t), device=latents.device)
            eps = unet_mod.apply(unet_params, self.cfg.unet,
                                 lat_in.to(unet_dtype), t_dev, ctx)
            eps = eps.to(latents.dtype)
            if do_cfg:
                eps_u, eps_t = eps.chunk(2)
                eps = eps_u + guidance_scale * (eps_t - eps_u)
            latents, state = self.scheduler.step(state, eps, t, latents,
                                                 ratio)
        return latents

    def decode_latents(self, latents):
        vp = self.params["vae_decoder"]
        latents = latents.to(tree_leaves(vp)[0].dtype)
        img = vae_mod.decode(vp, self.cfg.vae, latents)
        return torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0)
