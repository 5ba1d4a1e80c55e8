"""Generate plain SD v1.5 images for PartiPrompts (counterpart of
scripts/generate_sd_p2_images.py; reference
scripts/generate_sd_p2_images.py).

    python -m gill_tpu_torch.scripts.generate_sd_p2_images \
        data/PartiPromptsAllDecisions.tsv p2_sd_outputs \
        --sd-dir /weights/stable-diffusion-v1-5

The first column of each row after the header is a prompt; batches of 16
go through the SD pipeline's `prompt=` path (50 PNDM steps, CFG 7.5,
512 x 512) with one torch.Generator seeded 1337, and image i is saved as
`<i>.png`. The weights come from --sd-dir (or GILL_TPU_WEIGHTS_DIR's
`stable-diffusion-v1-5/`) through weights/loader.py `load_sd`; without
them the pipeline is random and, without `tokenizer/`, the tokenizer is
`CLIPBPETokenizer.tiny()`, each with a warning. On the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from gill_tpu_torch.utils.cli import add_device_arg, model_dtype, \
    resolve_device


def read_prompts(p2_fn: str) -> list:
    with open(p2_fn) as f:
        return [line.strip().split("\t")[0] for line in f.readlines()[1:]]


@torch.no_grad()
def generate_p2(pipe, captions, output_dir: str, *, batch_size: int = 16,
                num_inference_steps: int = 50, seed: int = 1337) -> list:
    """Saves `<i>.png` for caption i; returns the paths."""
    os.makedirs(output_dir, exist_ok=True)
    dev = pipe.params["unet"]["conv_in"]["b"].device
    g = torch.Generator(dev).manual_seed(seed)
    paths = []
    for i in range(0, len(captions), batch_size):
        arr = pipe(prompt=captions[i:i + batch_size],
                   num_inference_steps=num_inference_steps,
                   generator=g).float().cpu().numpy()
        for img in arr:
            path = os.path.join(output_dir, f"{len(paths)}.png")
            Image.fromarray((img * 255).round().astype(np.uint8)).save(path)
            paths.append(path)
        print(f"{min(i + batch_size, len(captions))}/{len(captions)}",
              flush=True)
    return paths


def main(argv=None):
    from gill_tpu_torch.config import SDPipelineConfig
    from gill_tpu_torch.models.sd.pipeline import StableDiffusionPipeline
    from gill_tpu_torch.tokenizer import CLIPBPETokenizer
    from gill_tpu_torch.weights import loader as wloader

    p = argparse.ArgumentParser()
    p.add_argument("p2_fn")
    p.add_argument("output_dir")
    p.add_argument("--sd-dir", default=None)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--num-inference-steps", type=int, default=50)
    add_device_arg(p)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = SDPipelineConfig()
    sd_dir = args.sd_dir or os.path.join(
        os.environ.get("GILL_TPU_WEIGHTS_DIR", ""), "stable-diffusion-v1-5")
    params, tok, _ = wloader.load_sd("stable-diffusion-v1-5", cfg, sd_dir,
                                     device=dev, dtype=model_dtype(dev))
    if tok is None:
        print("WARNING: no SD tokenizer; using CLIPBPETokenizer.tiny().")
        tok = CLIPBPETokenizer.tiny()
    pipe = StableDiffusionPipeline(cfg, params, tokenizer=tok)
    generate_p2(pipe, read_prompts(args.p2_fn), args.output_dir,
                batch_size=args.batch_size,
                num_inference_steps=args.num_inference_steps)


if __name__ == "__main__":
    main()
