"""Generate the last image of VIST stories (counterpart of
evals/generate_vist_images.py; reference evals/generate_vist_images.py).

    python -m gill_tpu_torch.evals.generate_vist_images gill_vist_outputs \
        --model-dir checkpoints/gill_opt --vist-dir sis/ [--batch 8]

The first n-1 steps of each story (caption, then its image at 224 x 224)
are the prompt; the last caption ends it, and
`generate_for_images_and_texts(num_words=2, gen_scale_factor=1e5)` with a
torch.Generator seeded 42 (a fresh one a call, as gill_tpu passes the
same key to every call) forces an [IMG]; the generated image is saved as
`<gt_image_id>.png`. `--batch N` decodes N stories at once through
`generate_for_images_and_texts_batch` (the continuous-batching engine;
greedy tokens equal to the sequential path's). On the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import torch
from PIL import Image

from gill_tpu_torch.utils.cli import add_device_arg, load_model, \
    resolve_device


def build_prompts(story_data, image_dir):
    """(interleaved prompt, ground-truth image id), or (None, None) when an
    image of the story is missing."""
    image_paths = [os.path.join(image_dir, s["image_id"] + ".png")
                   for s in story_data][:-1]
    if not all(os.path.exists(pth) for pth in image_paths):
        return None, None
    captions = [s["caption"] for s in story_data]
    input_data = []
    for i, caption in enumerate(captions):
        input_data.append(caption)
        if i < len(captions) - 1:
            with open(image_paths[i], "rb") as f:
                input_data.append(
                    Image.open(f).convert("RGB").resize((224, 224)))
    return input_data, story_data[-1]["image_id"]


def generate_all(model, named_prompts, output_dir: str, *, batch: int = 1,
                 num_inference_steps: int = 50, seed: int = 42) -> dict:
    """Forced-[IMG] generation for each (name, prompt) of an iterable
    (read as it is served); saves `<name>.png` in output_dir and returns
    {name: the text before the image, its [IMG] run included}. batch > 1
    serves `batch` prompts a call through the batch API (at most 8
    slots)."""
    os.makedirs(output_dir, exist_ok=True)
    kw = dict(num_words=2, gen_scale_factor=1e5,
              num_inference_steps=num_inference_steps)
    results = {}

    def save(outs, name):
        path = os.path.join(output_dir, f"{name}.png")
        outs[1]["gen"][0][0].save(path)
        if len(results) < 3:
            print("Saved", path)
        results[name] = outs[0]

    def generator():
        return torch.Generator(model.device).manual_seed(seed)

    it = iter(named_prompts)
    if batch > 1:
        while chunk := list(itertools.islice(it, batch)):
            all_outs = model.generate_for_images_and_texts_batch(
                [p for _, p in chunk], slots=min(8, len(chunk)),
                generator=generator(), **kw)
            for outs, (name, _) in zip(all_outs, chunk):
                save(outs, name)
    else:
        for name, prompt in it:
            save(model.generate_for_images_and_texts(
                prompt, generator=generator(), **kw), name)
    return results


def story_prompts(vist_dir: str, limit: int = -1):
    """Yields (gt image id, prompt) for val_formatted.json's stories (the
    first `limit` when > 0), skipping stories with a missing image."""
    image_dir = os.path.join(vist_dir, "val_images")
    with open(os.path.join(vist_dir, "val_formatted.json")) as f:
        items = list(json.load(f)["annotations"].items())
    if limit > 0:
        items = items[:limit]
    for story_id, story_data in items:
        prompt, gt_id = build_prompts(story_data, image_dir)
        if prompt is None:
            print(f"Missing images; skipping story {story_id}")
            continue
        yield gt_id, prompt


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("output_dir")
    p.add_argument("--model-dir", default="checkpoints/gill_opt")
    p.add_argument("--vist-dir", default="sis")
    p.add_argument("--weights-dir", default=None)
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--limit", type=int, default=-1)
    p.add_argument("--batch", type=int, default=1,
                   help="stories decoded concurrently over the "
                        "continuous-batching engine")
    add_device_arg(p)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    model = load_model(args.model_dir, dev, args.weights_dir,
                       load_ret_embs=False)
    return generate_all(model, story_prompts(args.vist_dir, args.limit),
                        args.output_dir, batch=args.batch,
                        num_inference_steps=args.num_inference_steps)


if __name__ == "__main__":
    main()
