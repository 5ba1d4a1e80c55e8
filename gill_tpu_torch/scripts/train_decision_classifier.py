"""Train the generate-vs-retrieve decision classifier on PartiPrompts
annotations (counterpart of scripts/train_decision_classifier.py;
reference TrainDecisionClassifier.ipynb).

    python -m gill_tpu_torch.scripts.train_decision_classifier \
        --annotations data/PartiPromptsDecisionsConfident.tsv \
        --model-dir checkpoints/gill_opt --out decision_model.npz

The features of a confident prompt are the [IMG0] hidden state of the
retrieval-mode forward of "{prompt}[IMG0]...[IMG{n-1}]" (`GILLCore.forward`,
16 prompts a batch, padded to 64 tokens). The classifier, Dropout(0.5) +
Linear(4096, 2) as models/decision.py applies it, trains with
`torch.optim.AdamW` at optax.adamw's defaults (lr 1e-3, weight decay
1e-4) on minibatches of 64 drawn with replacement from a torch.Generator
seeded --seed; every 100 steps the validation macro-F1 picks the best
(the human baseline is 0.8511). The `.npz` (`w` (in, 2), `b` (2,)) loads
with utils/ckpt.py `load_decision_model`. On the card unless `--device
cpu` is given.
"""

from __future__ import annotations

import argparse
import csv
import math

import numpy as np
import torch
import torch.nn.functional as F

from gill_tpu_torch.utils.cli import add_device_arg, load_model, \
    resolve_device

LABELS = {"gen": 0, "ret": 1}


def macro_f1(preds, labels, n_classes=2):
    f1s = []
    for c in range(n_classes):
        tp = np.sum((preds == c) & (labels == c))
        fp = np.sum((preds == c) & (labels != c))
        fn = np.sum((preds != c) & (labels == c))
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        f1s.append(2 * prec * rec / max(prec + rec, 1e-9))
    return float(np.mean(f1s))


def read_annotations(path: str):
    """(prompts, labels) of the rows labelled gen or ret."""
    prompts, labels = [], []
    with open(path, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            dec = row["Decision"].strip()
            if dec in LABELS:
                prompts.append(row["Prompt"])
                labels.append(LABELS[dec])
    return prompts, np.asarray(labels, np.int32)


@torch.no_grad()
def extract_features(model, prompts, bs: int = 16, max_len: int = 64):
    """(N, LM width) fp32 [IMG0] hidden states of each prompt + its [IMG]
    run, from the retrieval-mode forward."""
    from gill_tpu_torch.nn.core import tree_leaves

    core, tok, dev = model.core, model.tokenizer, model.device
    img_run = "".join(f"[IMG{i}]" for i in range(core.cfg.num_tokens))
    size = core.vis_cfg.image_size
    pixel_dtype = tree_leaves(model.params["vision"])[0].dtype
    feats = []
    for i in range(0, len(prompts), bs):
        chunk = prompts[i:i + bs]
        enc = tok([c + img_run for c in chunk], padding="max_length",
                  truncation=True, max_length=max_len, return_tensors="np")
        lens = torch.from_numpy(enc.attention_mask.sum(axis=1)).to(dev)
        out = core.forward(
            model.params, torch.zeros((len(chunk), size, size, 3),
                                      dtype=pixel_dtype, device=dev),
            torch.from_numpy(enc.input_ids).to(dev), lens, mode="retrieval")
        feats.append(out["llm_hidden"][:, 0, :].float().cpu().numpy())
        print(f"features {min(i + bs, len(prompts))}/{len(prompts)}",
              flush=True)
    return np.concatenate(feats)


def init_params(in_dim: int, generator: torch.Generator, device) -> dict:
    """Linear(in_dim, 2) as models/decision.py holds it, `w` (in, 2), fp32,
    U(-1/sqrt(in), 1/sqrt(in)) (gill_tpu decision.init), leaf tensors that
    require a gradient."""
    bound = 1.0 / math.sqrt(in_dim)

    def u(*shape):
        t = torch.empty(shape, device=device).uniform_(-bound, bound,
                                                       generator=generator)
        return t.requires_grad_(True)

    return {"w": u(in_dim, 2), "b": u(2)}


def make_optimizer(params: dict, lr: float) -> torch.optim.AdamW:
    """AdamW at optax.adamw's defaults (betas (0.9, 0.999), eps 1e-8
    outside the square root, weight decay 1e-4)."""
    return torch.optim.AdamW([params["w"], params["b"]], lr=lr,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def train_step(params: dict, opt, xb, yb, keep=None) -> torch.Tensor:
    """One AdamW step on the mean cross-entropy; `keep` is the dropout
    mask (rate 0.5; None: no dropout). Returns the loss (0-d, on the
    device: reading it waits for the step)."""
    x = xb if keep is None else torch.where(keep, xb / 0.5,
                                            torch.zeros_like(xb))
    with torch.enable_grad():                # callers may hold no_grad
        loss = F.cross_entropy(x @ params["w"] + params["b"], yb.long())
        opt.zero_grad()
        loss.backward()
    opt.step()
    return loss.detach()


def train_classifier(x: np.ndarray, y: np.ndarray, device, *,
                     steps: int = 2000, lr: float = 1e-3,
                     train_frac: float = 0.8, seed: int = 0):
    """Trains on a seeded split (numpy's permutation, as gill_tpu's);
    returns ({"w", "b"} numpy of the best validation macro-F1, that F1)."""
    order = np.random.RandomState(seed).permutation(len(x))
    n_train = int(len(x) * train_frac)
    tr, va = order[:n_train], order[n_train:]
    xt = torch.from_numpy(x[tr]).float().to(device)
    yt = torch.from_numpy(y[tr]).to(device)
    xv = torch.from_numpy(x[va]).float().to(device)
    g = torch.Generator(device).manual_seed(seed)
    params = init_params(x.shape[1], g, device)
    opt = make_optimizer(params, lr)

    def snapshot():
        return {k: v.detach().cpu().numpy().copy() for k, v in params.items()}

    best_f1, best = -1.0, snapshot()
    for it in range(steps):
        idx = torch.randint(len(tr), (min(64, len(tr)),), generator=g,
                            device=device)
        xb = xt[idx]
        keep = torch.rand(xb.shape, generator=g, device=device) < 0.5
        loss = train_step(params, opt, xb, yt[idx], keep)
        if (it + 1) % 100 == 0:
            with torch.no_grad():
                preds = (xv @ params["w"] + params["b"]).argmax(-1)
            f1 = macro_f1(preds.cpu().numpy(), y[va])
            print(f"step {it + 1}: loss {float(loss):.4f} val macro-F1 "
                  f"{f1:.4f}")
            if f1 > best_f1:
                best_f1, best = f1, snapshot()
    return best, best_f1


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--annotations",
                   default="data/PartiPromptsDecisionsConfident.tsv")
    p.add_argument("--model-dir", default="checkpoints/gill_opt")
    p.add_argument("--weights-dir", default=None)
    p.add_argument("--out", default="decision_model.npz")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--train-frac", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    prompts, labels = read_annotations(args.annotations)
    print(f"{len(prompts)} confident gen/ret examples")
    model = load_model(args.model_dir, dev, args.weights_dir,
                       load_ret_embs=False, load_sd=False)
    x = extract_features(model, prompts)
    best, best_f1 = train_classifier(x, labels, dev, steps=args.steps,
                                     lr=args.lr, train_frac=args.train_frac,
                                     seed=args.seed)
    np.savez(args.out, w=best["w"], b=best["b"])
    print(f"Saved {args.out} (best val macro-F1 {best_f1:.4f}; human "
          f"baseline 0.8511)")
    return best, best_f1


if __name__ == "__main__":
    main()
