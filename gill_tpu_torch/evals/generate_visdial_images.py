"""Generate images from VisDial dialogue contexts (counterpart of
evals/generate_visdial_images.py; reference
evals/generate_visdial_images.py).

    python -m gill_tpu_torch.evals.generate_visdial_images out/ \
        --visdial-dir VisualDialog/ --model-dir checkpoints/gill_opt

Each dialogue of `visdial_1.0_val.json` is joined as "Q: ...?" / "A: ..."
lines and generated as evals/generate_vist_images.py generates a story
(num_words=2, gen_scale_factor=1e5, a torch.Generator seeded 42 a call;
`--batch N` through the batch API), one image a dialogue saved as its
zero-padded image id. On the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os

from gill_tpu_torch.evals.generate_vist_images import generate_all
from gill_tpu_torch.utils.cli import add_device_arg, load_model, \
    resolve_device


def dialog_prompts(visdial_dir: str, limit: int = -1, split: str = "val"):
    """Yields (zero-padded image id, [dialogue text]) for the first
    `limit` dialogues (all when <= 0); the first three are printed."""
    with open(os.path.join(visdial_dir, f"visdial_1.0_{split}.json")) as f:
        visdial_data = json.load(f)
    with open(os.path.join(visdial_dir,
                           f"visdial_1.0_{split}_dense_annotations.json")) as f:
        dense_data = json.load(f)
    dialogs = visdial_data["data"]["dialogs"]
    if len(dense_data) != len(dialogs):
        raise ValueError(f"{len(dense_data)} dense annotations for "
                         f"{len(dialogs)} dialogues")
    questions = visdial_data["data"]["questions"]
    answers = visdial_data["data"]["answers"]
    n = len(dialogs) if limit <= 0 else min(limit, len(dialogs))
    for idx in range(n):
        contexts = []
        for turn in dialogs[idx]["dialog"]:
            contexts.append("Q: " + questions[turn["question"]] + "?")
            contexts.append("A: " + answers[turn["answer"]])
        cond = "\n".join(contexts)
        if idx < 3:
            print(cond)
        yield str(dialogs[idx]["image_id"]).rjust(12, "0"), [cond]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("output_dir")
    p.add_argument("--model-dir", default="checkpoints/gill_opt")
    p.add_argument("--visdial-dir", default="VisualDialog")
    p.add_argument("--weights-dir", default=None)
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--limit", type=int, default=-1)
    p.add_argument("--batch", type=int, default=1,
                   help="dialogs decoded concurrently over the "
                        "continuous-batching engine")
    add_device_arg(p)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    model = load_model(args.model_dir, dev, args.weights_dir,
                       load_ret_embs=False)
    return generate_all(model, dialog_prompts(args.visdial_dir, args.limit),
                        args.output_dir, batch=args.batch,
                        num_inference_steps=args.num_inference_steps)


if __name__ == "__main__":
    main()
