"""Validation loop (gill_tpu/train/validate.py; reference
gill/validate.py:18-343).

Per batch the three modes run with the "A picture of" prefix and no
gradient (so the kernels run); captioning also greedy-decodes captions for
BLEU-1..4; the retrieval embeddings of the whole validation set are kept
for its full-matrix top-1/5 in both directions (the model-selection
metric, validate.py:343). Under data parallelism (`core.mesh`) each rank
runs its loader's rows, the eval step's metrics are the global batch's
(train/trainer.py), and the visual and text embeddings and the caption
tokens are gathered over "data" every batch (gill_tpu's
process_allgather; the reference's NCCL all_gathers,
validate.py:94-155), so retrieval accuracy and BLEU cover the whole set
on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gill_tpu_torch.parallel.collectives import gather_rows, global_count
from gill_tpu_torch.train.bleu import bleu_score
from gill_tpu_torch.train.trainer import make_eval_step, put_batch as _put
from gill_tpu_torch.utils.meters import AverageMeter, ProgressMeter


def _embed_for_caption_decode(core, params, pixels, prefix_ids):
    vis = core.get_visual_embs(params, pixels, "captioning")
    parts = [vis]
    if prefix_ids is not None and len(prefix_ids):
        pe = core.embed_tokens(params, prefix_ids.long()[None])
        parts.append(pe.expand(vis.shape[0], -1, -1).to(vis.dtype))
    return torch.cat(parts, dim=1)


@torch.no_grad()
def generate_caption_tokens(core, params, pixels, prefix_ids,
                            num_words: int = 32) -> np.ndarray:
    """Greedy caption decode after the prefix (reference
    validate.py:123-137); min_word_tokens == num_words, so no [IMG] token
    is sampled mid-caption. Returns (B, S) int32 with pad at invalid
    positions."""
    embs = _embed_for_caption_decode(core, params, pixels, prefix_ids)
    out = core.generate(params, embs, num_words=num_words,
                        min_word_tokens=num_words, temperature=0.0,
                        max_img_runs=1)
    toks = out["tokens"].cpu().numpy()
    valid = out["valid"].cpu().numpy()
    return np.where(valid, toks, core.pad_token_id).astype(np.int32)


def decode_tokens(tokenizer, rows, strip_img_tokens: int = 0) -> list:
    """strip_img_tokens=N removes the literal [IMG0..N) strings after
    decode, as the reference strips them from the BLEU ground truth
    (gill/validate.py:230-232): skip_special_tokens does not cover tokens
    added with add_tokens()."""
    caps = [tokenizer.decode(r, skip_special_tokens=True) for r in rows]
    if strip_img_tokens:
        for i in range(strip_img_tokens):
            caps = [c.replace(f"[IMG{i}]", "") for c in caps]
        caps = [c.strip() for c in caps]
    return caps


def generate_captions(core, params, pixels, prefix_ids, tokenizer,
                      num_words: int = 32) -> list:
    """Greedy captions of `pixels` after the prefix, decoded to text
    (`generate_caption_tokens` then `decode_tokens`)."""
    toks = generate_caption_tokens(core, params, pixels, prefix_ids,
                                   num_words)
    return decode_tokens(tokenizer, toks)


def validate(core, tc, adapters, frozen, val_loader, tokenizer,
             epoch: int = 0, writer=None, prefix_ids=None,
             max_steps: Optional[int] = None, decode_captions: bool = True,
             device="cuda", pixel_dtype=None) -> float:
    """Runs the validation set (at most `max_steps` batches); logs the
    meters, writes val/* scalars and the caption grid, and returns the
    text-to-image top-1 (the model-selection metric). `prefix_ids`: a (P,)
    device tensor or None; batches go to `device` through
    `trainer.put_batch` with the pixels in `pixel_dtype`."""
    eval_step = make_eval_step(core, tc, prefix_ids=prefix_ids)
    meters = {k: AverageMeter(k, ":.4f") for k in
              ("loss", "cap_ce", "ret_ce", "gen_ce", "cont_loss", "gen_l2",
               "cap_top1", "cap_top5")}
    all_vis, all_txt = [], []
    gen_caps, gt_caps = [], []
    steps = max_steps if max_steps and max_steps > 0 else len(val_loader)
    progress = ProgressMeter(steps, list(meters.values()), prefix="Val: ")
    params = {"lm": frozen["lm"], "vision": frozen["vision"],
              "adapters": adapters}
    nt = core.cfg.num_tokens

    def gather(x):
        return gather_rows(x, core.mesh)

    for i, batch in enumerate(val_loader):
        if i >= steps:
            break
        jb = _put(batch, device, pixel_dtype)
        metrics = eval_step(adapters, frozen, jb, concat=False)
        rows = int(global_count(torch.tensor(len(batch["ret_tokens"])),
                                core.mesh))
        for k, m in meters.items():
            m.update(float(metrics[k]), rows)
        with torch.no_grad():
            r = core.forward(params, jb["pixels"], jb["ret_tokens"],
                             jb["ret_len"], mode="retrieval",
                             prefix_ids=prefix_ids)
        all_vis.append(gather(r["visual_embs"].float()))
        all_txt.append(gather(r["last_embedding"].float()))
        del r

        if decode_captions:
            toks = generate_caption_tokens(core, params, jb["pixels"],
                                           prefix_ids)
            gen_caps.extend(decode_tokens(tokenizer, gather(toks)))
            gt_caps.extend(decode_tokens(tokenizer,
                                         gather(batch["ret_tokens"]),
                                         strip_img_tokens=nt))
            if i == 0 and writer is not None:
                # input | GT caption | generated caption
                # (reference validate.py:196-211)
                from gill_tpu_torch.utils.image import (CLIP_MEAN, CLIP_STD,
                                                        caption_grid)

                px = np.clip(np.asarray(batch["pixels"], np.float32)
                             * CLIP_STD + CLIP_MEAN, 0, 1)
                # this rank's rows
                grid = caption_grid(
                    px, decode_tokens(tokenizer, batch["ret_tokens"],
                                      strip_img_tokens=nt),
                    decode_tokens(tokenizer, toks))
                writer.add_image("val/images_captioning",
                                 grid.transpose(2, 0, 1), epoch + 1)
        if i % 10 == 0:
            progress.display(i + 1)

    # whole-set retrieval top-1/5 (reference validate.py:248-265)
    vis = np.concatenate(all_vis)
    txt = np.concatenate(all_txt)
    sims = vis @ txt.T
    n = sims.shape[0]
    order_i2t = np.argsort(-sims, axis=1)
    order_t2i = np.argsort(-sims.T, axis=1)
    tgt = np.arange(n)
    top1_i2t = float((order_i2t[:, 0] == tgt).mean() * 100)
    top5_i2t = float((order_i2t[:, :5] == tgt[:, None]).any(1).mean() * 100)
    top1_t2i = float((order_t2i[:, 0] == tgt).mean() * 100)
    top5_t2i = float((order_t2i[:, :5] == tgt[:, None]).any(1).mean() * 100)

    results: Dict[str, float] = {f"val/{k}": m.avg for k, m in meters.items()}
    results.update({
        "val/t2i_top1": top1_t2i, "val/t2i_top5": top5_t2i,
        "val/i2t_top1": top1_i2t, "val/i2t_top5": top5_i2t,
        "val/top1": (top1_t2i + top1_i2t) / 2,
        "val/top5": (top5_t2i + top5_i2t) / 2,
    })
    if gen_caps:
        b1, b2, b3, b4 = bleu_score(gen_caps, gt_caps)
        results.update({"val/bleu1": b1 * 100, "val/bleu2": b2 * 100,
                        "val/bleu3": b3 * 100, "val/bleu4": b4 * 100})
    if writer is not None:
        for k, v in results.items():
            writer.add_scalar(k, v, epoch + 1)
    print(" * " + "  ".join(f"{k}={v:.3f}" for k, v in results.items()),
          flush=True)
    return results["val/t2i_top1"]
