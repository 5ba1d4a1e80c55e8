"""Image utilities for the inference path (counterpart of
gill_tpu/utils/image.py): CLIP preprocessing into NHWC float arrays, the
URL fetch of retrieved images, and caption truncation. Normalization
constants match HF CLIPImageProcessor; a CPU test holds the output equal
to gill_tpu's."""

from __future__ import annotations

import io

import numpy as np
from PIL import Image

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_preprocess(img: Image.Image, image_size: int = 224) -> np.ndarray:
    """PIL image -> (H, W, 3) float32, CLIP-normalized (resize shortest side
    bicubic + center crop + rescale + normalize)."""
    img = img.convert("RGB")
    w, h = img.size
    short = min(w, h)
    nw, nh = round(w * image_size / short), round(h * image_size / short)
    img = img.resize((nw, nh), Image.BICUBIC)
    left = (nw - image_size) // 2
    top = (nh - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def get_image_from_url(url: str) -> Image.Image:
    """Fetch + resize to 224x224 RGB (reference gill/utils.py:24-29). Only
    http(s) URLs are fetched; anything else raises at once, so a local
    index whose paths are not URLs never touches the network."""
    if not url.startswith(("http://", "https://")):
        raise ValueError(f"not an http(s) URL: {url!r}")
    import requests

    response = requests.get(url, timeout=10)
    img = Image.open(io.BytesIO(response.content))
    return img.resize((224, 224)).convert("RGB")


def truncate_caption(caption: str) -> str:
    """Truncate at the first newline, else the first period
    (reference gill/utils.py:32-40)."""
    caption = caption.strip("\n")
    idx = caption.find("\n") + 1
    if idx <= 0:
        idx = caption.find(".") + 1
    if idx > 0:
        caption = caption[:idx]
    return caption
