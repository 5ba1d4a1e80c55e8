"""CLIP ViT-L/14 cosine similarity between generated and ground-truth
images (counterpart of evals/compute_clip_similarity.py; reference
evals/compute_clip_similarity_vist.py and _visdial.py).

    python -m gill_tpu_torch.evals.compute_clip_similarity --dataset vist \
        --gen-dir gill_vist_outputs --gt-dir sis/val_images \
        --data-path sis/val_formatted.json --weights-dir /weights

The cosine of the port's `models/clip.py get_image_features` (fp32; its
attention is the flash kernel on the card), averaged over the pairs,
printed and written to --out (default `<dataset>_clip_similarity.txt`).
Without local CLIP weights (weights/loader.py's search rules) the tower
is random with a warning and an identity projection, as in gill_tpu.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
from PIL import Image

from gill_tpu_torch.utils.cli import add_device_arg, resolve_device


def pairs_vist(data_path, gt_dir, gen_dir):
    """(ground truth, generated) paths: each story's last image."""
    with open(data_path) as f:
        vist = json.load(f)
    for story in vist["annotations"].values():
        gt_id = story[-1]["image_id"]
        yield (os.path.join(gt_dir, gt_id + ".png"),
               os.path.join(gen_dir, gt_id + ".png"))


def pairs_visdial(data_path, gt_dir, gen_dir):
    """(ground truth, generated) paths: each dialogue's image."""
    with open(data_path) as f:
        visdial = json.load(f)
    for dialog in visdial["data"]["dialogs"]:
        image_id = str(dialog["image_id"]).rjust(12, "0")
        yield (os.path.join(gt_dir, f"VisualDialog_val2018_{image_id}.jpg"),
               os.path.join(gen_dir, f"{image_id}.png"))


def load_clip(name: str, weights_dir, device):
    """(params, cfg) of CLIP vision `name` in fp32 on `device`: local
    weights, else a random tower (seed 0) with an identity projection to
    768 and a warning."""
    from gill_tpu_torch.config import CLIPVisionConfig
    from gill_tpu_torch.models import clip as clip_mod
    from gill_tpu_torch.nn.core import Init
    from gill_tpu_torch.weights import loader as wloader

    cfg = CLIPVisionConfig.from_name(name)
    if wloader._model_dir(name, weights_dir) is None:
        print("WARNING: CLIP weights unavailable; scores will be meaningless "
              "(random init).")
        init = Init(torch.Generator(device).manual_seed(0), device)
        params = clip_mod.init_vision(init, cfg)
        params["visual_projection"] = {
            "w": torch.eye(cfg.hidden_size, 768, device=device)}
    else:
        params = wloader.load_clip_vision(name, cfg, weights_dir,
                                          device=device, dtype=torch.float32)
    return params, cfg


@torch.no_grad()
def cos_sim(params, cfg, px_a, px_b):
    """Cosine of the CLIP image features of two (N, H, W, 3) batches."""
    from gill_tpu_torch.models import clip as clip_mod

    fa = clip_mod.get_image_features(params, cfg, px_a).float()
    fb = clip_mod.get_image_features(params, cfg, px_b).float()
    fa = fa / torch.linalg.vector_norm(fa, dim=-1, keepdim=True)
    fb = fb / torch.linalg.vector_norm(fb, dim=-1, keepdim=True)
    return (fa * fb).sum(-1)


def score_pairs(params, cfg, pairs, device) -> list:
    """The similarity of each (ground truth, generated) pair whose two
    files exist (a missing one is reported and skipped)."""
    from gill_tpu_torch.utils.image import clip_preprocess

    def px(path):
        arr = clip_preprocess(Image.open(path), cfg.image_size)[None]
        return torch.from_numpy(arr).to(device)

    scores = []
    for gt_path, gen_path in pairs:
        if not (os.path.exists(gt_path) and os.path.exists(gen_path)):
            print(f"Skipping missing pair {gt_path} / {gen_path}")
            continue
        scores.append(float(cos_sim(params, cfg, px(gen_path), px(gt_path))[0]))
    return scores


def main(argv=None) -> float:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", choices=["vist", "visdial"], required=True)
    p.add_argument("--gen-dir", required=True)
    p.add_argument("--gt-dir", required=True)
    p.add_argument("--data-path", required=True)
    p.add_argument("--weights-dir", default=None)
    p.add_argument("--clip-model", default="openai/clip-vit-large-patch14")
    p.add_argument("--out", default=None)
    add_device_arg(p)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    params, cfg = load_clip(args.clip_model, args.weights_dir, dev)
    pair_fn = pairs_vist if args.dataset == "vist" else pairs_visdial
    scores = score_pairs(params, cfg, pair_fn(args.data_path, args.gt_dir,
                                              args.gen_dir), dev)
    score = float(np.mean(scores)) if scores else float("nan")
    print("CLIP similarity:", score)
    out = args.out or f"{args.dataset}_clip_similarity.txt"
    with open(out, "w") as wf:
        wf.write(str(score))
    return score


if __name__ == "__main__":
    main()
