"""Scripted inference examples (counterpart of
examples/inference_examples.py; reference GILL_Inference_Examples.ipynb):
greedy demonstrations of the three output routes and the scorer.

    python -m gill_tpu_torch.examples.inference_examples \
        --model-dir checkpoints/gill_opt --image example.jpg \
        --out-dir example_outputs

1. a caption / QA turn (text route, 32 words, at least 8);
2. a forced image (num_words=2, gen_scale_factor=1e5: retrieval, the
   decision MLP and a 50-step SD generation);
3. a dialogue turn with ret_scale_factor 1.3;
4. `get_log_likelihood_scores` of the first prompt.
Each generation takes a torch.Generator seeded 1337 (a fresh one a call,
as gill_tpu passes the same key to each). Images are saved under
--out-dir as `<example>_ret<i>.png` / `<example>_gen<i>.png`. On the card
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os

import torch
from PIL import Image

from gill_tpu_torch.utils.cli import add_device_arg, load_model, \
    resolve_device


def show(outs, tag: str, out_dir: str) -> None:
    """Prints the text and decisions of `outs` and saves its images."""
    print(f"--- {tag} ---")
    for o in outs:
        if isinstance(o, str):
            print("text:", o)
        else:
            print("decision:", o["decision"])
            for i, (img, *_rest) in enumerate(o["ret"]):
                img.save(os.path.join(out_dir, f"{tag}_ret{i}.png"))
            for i, (img, _score) in enumerate(o["gen"]):
                if isinstance(img, Image.Image):
                    img.save(os.path.join(out_dir, f"{tag}_gen{i}.png"))


def run_examples(model, out_dir: str, image=None, seed: int = 1337,
                 num_inference_steps: int = 50) -> dict:
    """The four examples on a loaded GILL; returns {example: outputs} and
    "log_likelihood"."""
    os.makedirs(out_dir, exist_ok=True)

    def generator():
        return torch.Generator(model.device).manual_seed(seed)

    prompts = []
    if image is not None:
        prompts.append(image.resize((224, 224)).convert("RGB"))
    prompts.append("Q: What would make a nice caption for this?\nA:")
    res = {
        "caption": model.generate_for_images_and_texts(
            prompts, num_words=32, min_word_tokens=8, generator=generator()),
        "forced_image": model.generate_for_images_and_texts(
            ["a watercolor painting of a lighthouse at sunset"],
            num_words=2, gen_scale_factor=1e5, generator=generator(),
            num_inference_steps=num_inference_steps),
        "dialogue": model.generate_for_images_and_texts(
            ["Q: show me something similar but at night\nA:"],
            num_words=32, ret_scale_factor=1.3, generator=generator())}
    for tag, outs in res.items():
        show(outs, tag, out_dir)
    with torch.no_grad():
        res["log_likelihood"] = model.get_log_likelihood_scores(prompts)
    print("log-likelihood of the caption prompt:", res["log_likelihood"])
    return res


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-dir", default="checkpoints/gill_opt")
    p.add_argument("--weights-dir", default=None)
    p.add_argument("--image", default=None, help="optional context image")
    p.add_argument("--out-dir", default="example_outputs")
    add_device_arg(p)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    model = load_model(args.model_dir, dev, args.weights_dir)
    image = Image.open(args.image) if args.image else None
    return run_examples(model, args.out_dir, image)


if __name__ == "__main__":
    main()
