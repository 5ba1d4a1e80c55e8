"""Extract retrieval embeddings for a list of image paths or URLs
(counterpart of scripts/extract_img_embs.py; reference
scripts/extract_img_embs.py).

    python -m gill_tpu_torch.scripts.extract_img_embs --out \
        cc3m_embeddings.pkl --model-dir checkpoints/gill_opt a.jpg b.jpg

Each image runs through the model's retrieval visual embedding
(`GILLCore.get_visual_embs(mode="retrieval")`, CLIP then `visual_fc`) in
batches of --batch-size, and the (path, embedding) pairs are written with
`retrieval.save_embeddings` in the pickled cc3m*.npy format `load_gill`
reads. On the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from PIL import Image

from gill_tpu_torch.utils.cli import add_device_arg, load_model, \
    resolve_device


def load_image(src: str) -> Image.Image:
    if src.startswith(("http://", "https://")):
        from gill_tpu_torch.utils.image import get_image_from_url

        return get_image_from_url(src)
    with open(src, "rb") as f:
        img = Image.open(f)
        img.load()
        return img


@torch.no_grad()
def extract(model, sources, batch_size: int = 32) -> np.ndarray:
    """(N, ret_emb_dim) fp32 retrieval embeddings of `sources`, in order."""
    from gill_tpu_torch.utils.image import clip_preprocess

    embs = []
    for i in range(0, len(sources), batch_size):
        px = np.stack([clip_preprocess(load_image(s),
                                       model.core.cfg.image_size)
                       for s in sources[i:i + batch_size]])
        v = model.core.get_visual_embs(
            model.params, torch.from_numpy(px).to(model.device),
            "retrieval")[:, 0, :]
        embs.append(v.float().cpu().numpy())
    return np.concatenate(embs)


def main(argv=None):
    from gill_tpu_torch.retrieval import save_embeddings

    p = argparse.ArgumentParser()
    p.add_argument("images", nargs="+", help="image urls or local paths")
    p.add_argument("--out", default="cc3m_embeddings.pkl")
    p.add_argument("--model-dir", default="checkpoints/gill_opt")
    p.add_argument("--weights-dir", default=None)
    p.add_argument("--batch-size", type=int, default=32)
    add_device_arg(p)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    model = load_model(args.model_dir, dev, args.weights_dir,
                       load_ret_embs=False, load_sd=False)
    embs = extract(model, args.images, args.batch_size)
    save_embeddings(args.out, args.images, embs)
    print(f"Wrote {len(args.images)} embeddings to {args.out}")


if __name__ == "__main__":
    main()
