"""Precompute SD text-conditioning embeddings for training captions
(counterpart of scripts/preprocess_sd_embeddings.py; reference
scripts/preprocess_sd_embeddings.py).

    python -m gill_tpu_torch.scripts.preprocess_sd_embeddings \
        --tsv datasets/cc3m_val.tsv --image-dir data/cc3m/validation \
        --sd-dir /weights/stable-diffusion-v1-5

Every (caption, image) row of the TSV whose
`<image_dir>/clip_embs/<image>.npy` does not exist yet is encoded by the
SD pipeline's text path (`prompt=`, `return_prompts_only=True`; the CLIP
text tower in fp32, its attention the flash kernel on the card) and saved
as a (77, 768) fp16 `.npy`. Without `text_encoder/` weights the tower is
random (seed 0) and the tokenizer `CLIPBPETokenizer.tiny()`, with a
warning, as in gill_tpu. On the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from gill_tpu_torch.utils.cli import add_device_arg, resolve_device


def text_pipeline(sd_dir: str, device, cfg=None):
    """A text-only StableDiffusionPipeline (fp32 text encoder and its
    tokenizer from `sd_dir`, else random and tiny) for `prompt=` calls."""
    from gill_tpu_torch.config import SDPipelineConfig
    from gill_tpu_torch.models import clip as clip_mod
    from gill_tpu_torch.models.sd.pipeline import StableDiffusionPipeline
    from gill_tpu_torch.nn.core import Init
    from gill_tpu_torch.tokenizer import CLIPBPETokenizer
    from gill_tpu_torch.weights.convert import clip_text_from_torch
    from gill_tpu_torch.weights.from_jax import tree_from_jax
    from gill_tpu_torch.weights.loader import load_state_dict_dir

    cfg = cfg or SDPipelineConfig()
    if os.path.isdir(os.path.join(sd_dir, "text_encoder")):
        sd = load_state_dict_dir(os.path.join(sd_dir, "text_encoder"),
                                 device=device, dtype=torch.float32)
        text = tree_from_jax(clip_text_from_torch(sd, cfg.text),
                             device=device, dtype=torch.float32)
        tok = CLIPBPETokenizer.from_files(
            os.path.join(sd_dir, "tokenizer", "vocab.json"),
            os.path.join(sd_dir, "tokenizer", "merges.txt"))
    else:
        print("WARNING: SD text encoder weights not found; using random "
              "weights + tiny tokenizer (smoke mode).")
        text = clip_mod.init_text(
            Init(torch.Generator(device).manual_seed(0), device), cfg.text)
        tok = CLIPBPETokenizer.tiny()
    return StableDiffusionPipeline(cfg, {"unet": None, "vae_decoder": None,
                                         "text_encoder": text}, tokenizer=tok)


def pending_rows(tsv: str, out_dir: str) -> list:
    """(caption, .npy path) of the TSV rows not written yet."""
    rows = []
    with open(tsv, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            out_path = os.path.join(out_dir, row["image"] + ".npy")
            if not os.path.exists(out_path):
                rows.append((row["caption"], out_path))
    return rows


@torch.no_grad()
def encode_rows(pipe, rows, batch_size: int = 64) -> None:
    """Encodes each (caption, path) and saves its fp16 embeddings."""
    for i in range(0, len(rows), batch_size):
        chunk = rows[i:i + batch_size]
        embs = pipe(prompt=[c for c, _ in chunk], return_prompts_only=True)
        embs = embs.float().cpu().numpy().astype(np.float16)
        for (_, out_path), e in zip(chunk, embs):
            np.save(out_path, e)
        print(f"{min(i + batch_size, len(rows))}/{len(rows)}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tsv", required=True)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--sd-dir", default=None,
                   help="diffusers-layout SD dir with text_encoder/ and "
                        "tokenizer/")
    p.add_argument("--batch-size", type=int, default=64)
    add_device_arg(p)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    sd_dir = args.sd_dir or os.path.join(
        os.environ.get("GILL_TPU_WEIGHTS_DIR", ""), "stable-diffusion-v1-5")
    pipe = text_pipeline(sd_dir, dev)
    out_dir = os.path.join(args.image_dir, "clip_embs")
    os.makedirs(out_dir, exist_ok=True)
    encode_rows(pipe, pending_rows(args.tsv, out_dir), args.batch_size)


if __name__ == "__main__":
    main()
