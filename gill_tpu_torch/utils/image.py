"""Image utilities (counterpart of gill_tpu/utils/image.py): CLIP
preprocessing into NHWC float arrays (`get_pixel_values`), square padding,
the URL fetch of retrieved images,
caption truncation, and the caption renders and grids of the trainer's
TensorBoard images. Normalization constants match HF CLIPImageProcessor;
CPU tests hold the outputs equal to gill_tpu's."""

from __future__ import annotations

import io

import numpy as np
from PIL import Image, ImageDraw, ImageFont, ImageOps

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


def get_pixel_values(img: Image.Image, image_size: int = 224) -> np.ndarray:
    """The reference's name for `clip_preprocess` (gill/utils.py)."""
    return clip_preprocess(img, image_size)


def pad_to_square(img: Image.Image) -> Image.Image:
    """Center-pads to a square with black (reference SquarePad,
    gill/utils.py:78-87)."""
    w, h = img.size
    m = max(w, h)
    left, top = (m - w) // 2, (m - h) // 2
    return ImageOps.expand(img, (left, top, m - w - left, m - h - top))


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


def create_image_of_text(text: bytes, width: int = 224, nrows: int = 2,
                         color=(255, 255, 255), font=None) -> np.ndarray:
    """Renders text into a (nrows*12 + 5, width, 3) float image for TB grids
    (reference gill/utils.py:90-108; HWC instead of CHW)."""
    height, padding = 12, 5
    eff_w = width - 2 * padding
    canvas = Image.new("RGB", (eff_w * nrows, height), (0, 0, 0))
    draw = ImageDraw.Draw(canvas)
    if isinstance(text, bytes):
        text = text.decode("ascii", "ignore")
    draw.text((0, 0), text, color, font=font or ImageFont.load_default())
    arr = np.asarray(canvas, np.float32) / 255.0          # (h, W*nrows, 3)
    rows = [arr[:, i * eff_w:(i + 1) * eff_w] for i in range(nrows)]
    arr = np.concatenate(rows, axis=0)                     # (h*nrows, W, 3)
    return np.pad(arr, ((0, padding), (padding, padding), (0, 0)))


def caption_grid(pixels, gt_captions, gen_captions, max_images: int = 16,
                 nrow: int = 4) -> np.ndarray:
    """Tiles (input image / GT caption render / generated caption render)
    stacks: the reference's train and val caption grids (main.py:687-702,
    validate.py:196-211). pixels: (N, H, W, 3) floats in [0, 1]; either
    caption list may be None to leave that band out."""
    n = min(len(pixels), max_images)
    if gt_captions is not None:
        n = min(n, len(gt_captions))
    if gen_captions is not None:
        n = min(n, len(gen_captions))
    w = pixels.shape[2]
    rows = []
    for i in range(n):
        parts = [np.asarray(pixels[i], np.float32)]
        if gt_captions is not None:
            parts.append(create_image_of_text(
                gt_captions[i].encode("ascii", "ignore"), width=w))
        if gen_captions is not None:
            parts.append(create_image_of_text(
                gen_captions[i].encode("ascii", "ignore"), width=w,
                color=(255, 255, 0)))
        rows.append(np.concatenate(parts, axis=0))
    return make_grid(np.stack(rows), nrow=nrow)


def make_grid(images: np.ndarray, nrow: int = 4,
              padding: int = 4) -> np.ndarray:
    """(N, H, W, 3) -> one tiled (gh, gw, 3) grid image for TB."""
    n, h, w, c = images.shape
    nrows = -(-n // nrow)
    grid = np.zeros((nrows * (h + padding) + padding,
                     nrow * (w + padding) + padding, c), images.dtype)
    for i in range(n):
        r, col = divmod(i, nrow)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y:y + h, x:x + w] = images[i]
    return grid
