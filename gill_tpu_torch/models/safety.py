"""Stable Diffusion safety checker (counterpart of gill_tpu/models/safety.py).

The `StableDiffusionSafetyChecker` the reference runs after the VAE decode
(reference gill/custom_sd.py:653-661; diffusers
`stable_diffusion/safety_checker.py`): a CLIP ViT-L/14 image tower and its
visual projection score each image against 17 "concept" and 3 "special
care" embeddings; a cosine above a concept's threshold (plus 0.01 once any
special-care concept fires), rounded to 3 decimals, flags the image, which
is then blacked out.

The resize to the tower's 224² is gill_tpu's `jax.image.resize(...,
"bicubic")`: Keys cubic with a = -0.5 and, downsampling, the kernel
stretched by the scale (antialiasing), half-pixel centres, weights
normalised per output pixel. `torch.nn.functional.interpolate` (a =
-0.75, no antialiasing) computes another function, so the resize here is
two precomputed separable weight matrices applied as products. The tower
runs in fp32 activations (K1 at 257 tokens on CUDA); only the flags cross
to the host.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from gill_tpu_torch.config import CLIPVisionConfig
from gill_tpu_torch.models import clip as clip_mod
from gill_tpu_torch.nn import core as nn

# CLIP image normalization (OpenAI constants; diffusers CLIPImageProcessor).
_MEAN = (0.48145466, 0.4578275, 0.40821073)
_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass
class SafetyCheckerConfig:
    vision: CLIPVisionConfig = dataclasses.field(
        default_factory=lambda: CLIPVisionConfig.from_name(
            "openai/clip-vit-large-patch14"))
    projection_dim: int = 768
    num_concepts: int = 17
    num_special: int = 3


def tiny_safety_config() -> SafetyCheckerConfig:
    return SafetyCheckerConfig(
        vision=CLIPVisionConfig(hidden_size=16, intermediate_size=32,
                                num_layers=1, num_heads=2, image_size=16,
                                patch_size=8),
        projection_dim=8, num_concepts=4, num_special=2)


def init(init: nn.Init, cfg: SafetyCheckerConfig) -> dict:
    """Random checker params from `init`'s generator (gill_tpu's
    distributions: N(0, 0.02) projection, N(0, 1) embeddings, thresholds
    0.2)."""
    vision = clip_mod.init_vision(init, cfg.vision)
    vision["visual_projection"] = {
        "w": init.normal((cfg.vision.hidden_size, cfg.projection_dim), 0.02)}
    return {
        "vision": vision,
        "concept_embeds": init.normal((cfg.num_concepts,
                                       cfg.projection_dim)),
        "special_care_embeds": init.normal((cfg.num_special,
                                            cfg.projection_dim)),
        "concept_embeds_weights": init.full((cfg.num_concepts,), 0.2),
        "special_care_embeds_weights": init.full((cfg.num_special,), 0.2),
    }


@functools.lru_cache(maxsize=16)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) fp32 weights of jax.image.resize(method="bicubic",
    antialias=True) along one axis (jax/_src/image/scale.py
    compute_weight_mat with scale n_out / n_in, translation 0)."""
    inv_scale = np.float32(1.0) / np.float32(n_out / n_in)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
         / kernel_scale).astype(np.float32)
    w = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    w = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                            - np.float32(4.0)) * x + np.float32(2.0), w)
    w = np.where(x >= 2.0, np.float32(0.0), w).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_bicubic(images, size: int):
    """(B, H, W, C) -> (B, size, size, C) fp32, jax.image.resize's bicubic
    (module docstring); an axis already at `size` is left as it is."""
    x = images.float()
    _, h, w, _ = x.shape
    if h != size:
        wh = torch.from_numpy(_resize_weights(h, size)).to(x.device)
        x = torch.einsum("bhwc,hH->bHwc", x, wh)
    if w != size:
        ww = torch.from_numpy(_resize_weights(w, size)).to(x.device)
        x = torch.einsum("bhwc,wW->bhWc", x, ww)
    return x


def _cosine(a, b):
    """diffusers' cosine_distance: normalized a @ normalized b.T."""
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    return a @ b.t()


def _round3(x):
    # diffusers rounds scores to 3 decimals before thresholding
    return torch.round(x * 1000.0) / 1000.0


def scores(params, cfg: SafetyCheckerConfig, images):
    """Unrounded (special (B, num_special), concept (B, num_concepts))
    scores: each cosine less its threshold, before the special-care
    adjustment."""
    sz = cfg.vision.image_size
    px = resize_bicubic(images, sz)
    mean = torch.tensor(_MEAN, device=px.device)
    std = torch.tensor(_STD, device=px.device)
    px = (px - mean) / std
    vision = params["vision"]
    pooled = clip_mod.vision_forward(vision, cfg.vision, px)["pooler_output"]
    image_embeds = (pooled @ vision["visual_projection"]["w"].to(
        pooled.dtype)).float()
    special = _cosine(image_embeds, params["special_care_embeds"].float()) \
        - params["special_care_embeds_weights"].float()[None, :]
    concept = _cosine(image_embeds, params["concept_embeds"].float()) \
        - params["concept_embeds_weights"].float()[None, :]
    return special, concept


def check_images(params, cfg: SafetyCheckerConfig, images):
    """The reference's run_safety_checker: (images, has_nsfw (B,) bool),
    flagged images replaced by black (diffusers zeroes them)."""
    special, concept = scores(params, cfg, images)
    special_care = (_round3(special) > 0).any(dim=1)
    adjustment = torch.where(special_care, 0.01, 0.0)[:, None]
    has_nsfw = (_round3(concept + adjustment) > 0).any(dim=1)
    images = torch.where(has_nsfw[:, None, None, None],
                         torch.zeros_like(images), images)
    return images, has_nsfw


class SafetyChecker:
    """Callable matching the SD pipeline's safety hook: images (B, H, W, 3)
    in [0, 1] -> (images, has_nsfw list of bool)."""

    def __init__(self, cfg: SafetyCheckerConfig, params: dict):
        self.cfg = cfg
        self.params = params

    def __call__(self, images):
        out, flags = check_images(self.params, self.cfg, images)
        flags = [bool(f) for f in flags.cpu().tolist()]
        if any(flags):
            print("Potential NSFW content was detected in one or more "
                  "images. A black image will be returned instead.")
        return out, flags


def load_safety_checker(path: str, *, device="cuda",
                        dtype=torch.float32) -> SafetyChecker:
    """A SafetyChecker (CLIP ViT-L/14's config, as gill_tpu's) from a
    diffusers `safety_checker/` directory (state dict with vision_model.* /
    visual_projection / concept buffers), on `device` in `dtype`."""
    from gill_tpu_torch.weights.convert import safety_checker_from_torch
    from gill_tpu_torch.weights.from_jax import tree_from_jax
    from gill_tpu_torch.weights.loader import load_state_dict_dir

    cfg = SafetyCheckerConfig()
    sd = load_state_dict_dir(path, device=device, dtype=dtype)
    params = tree_from_jax(safety_checker_from_torch(sd, cfg), device=device,
                           dtype=dtype)
    return SafetyChecker(cfg, params)
