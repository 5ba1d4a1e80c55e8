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

`quantize=True` is the opt-in W8A8 UNet (sd_precision="int8",
unet.quantize_params, ops/quant.py); `sampler="dpm++"` takes DPM-Solver++
2M in place of PNDM. The pipeline never sets the UNet's `q8`, as gill_tpu's
does not.
"""

from __future__ import annotations

from typing import Optional

import torch

from gill_tpu_torch.config import SDPipelineConfig
from gill_tpu_torch.models.sd import unet as unet_mod
from gill_tpu_torch.models.sd import vae as vae_mod
from gill_tpu_torch.models.sd.scheduler import SAMPLERS, PNDMScheduler
from gill_tpu_torch.nn.core import tree_leaves


class StableDiffusionPipeline:
    def __init__(self, cfg: SDPipelineConfig, params: dict,
                 scheduler: Optional[PNDMScheduler] = None,
                 quantize: bool = False, sampler: str = "pndm"):
        """params: {"unet", "vae_decoder", optional "text_encoder"}.
        quantize: quantize the UNet's convs and linears once, here
        (unet.quantize_params). sampler: "pndm" (the reference's) or
        "dpm++"; an explicit `scheduler` overrides it."""
        self.cfg = cfg
        if quantize and params.get("unet") is not None:
            params = dict(params)
            params["unet"] = unet_mod.quantize_params(params["unet"])
        self.quantized = quantize
        self.params = params
        if scheduler is None:
            if sampler not in SAMPLERS:
                raise ValueError(f"sampler {sampler!r} not in {list(SAMPLERS)}")
            scheduler = SAMPLERS[sampler](cfg.scheduler)
        self.scheduler = scheduler
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
        """The CFG denoise loop. The UNet runs in the dtype of its
        `conv_in` weight, or of `conv_in`'s bias where quantization
        replaced the weight by int8 `wq` (gill_tpu reads `conv_in["w"]`
        there and raises KeyError, so its quantized pipeline fails on its
        first call; the port does what that rule evidently means)."""
        ts, ratio = self.scheduler.timesteps(num_inference_steps)
        state = self.scheduler.init_state(latents)
        unet_params = self.params["unet"]
        conv_in = unet_params["conv_in"]
        unet_dtype = (conv_in["w"] if "w" in conv_in else conv_in["b"]).dtype
        do_cfg = guidance_scale > 1.0
        ctx = ctx.to(unet_dtype)
        # multistep solvers on a non-uniform grid need the NEXT timestep;
        # uniform-grid schedulers derive it from step_ratio
        prev_fn = getattr(self.scheduler, "prev_timesteps", None)
        prevs = prev_fn(ts) if prev_fn is not None else [None] * len(ts)
        for t, pt in zip(ts, prevs):
            lat_in = torch.cat([latents, latents]) if do_cfg else latents
            t_dev = torch.tensor(float(t), device=latents.device)
            eps = unet_mod.apply(unet_params, self.cfg.unet,
                                 lat_in.to(unet_dtype), t_dev, ctx)
            eps = eps.to(latents.dtype)
            if do_cfg:
                eps_u, eps_t = eps.chunk(2)
                eps = eps_u + guidance_scale * (eps_t - eps_u)
            kw = {} if prev_fn is None else {"prev_timestep": pt}
            latents, state = self.scheduler.step(state, eps, t, latents,
                                                 ratio, **kw)
        return latents

    def decode_latents(self, latents):
        vp = self.params["vae_decoder"]
        latents = latents.to(tree_leaves(vp)[0].dtype)
        img = vae_mod.decode(vp, self.cfg.vae, latents)
        return torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0)
