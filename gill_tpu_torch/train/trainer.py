"""The training step (gill_tpu/train/trainer.py; the reference's per-step
work, main.py:462-607).

One step = three forwards (captioning / retrieval / generation) on the
same batch, one combined loss, clip-by-global-norm AdamW on the adapters
only, then the [IMG]-row renorm:

  total = cap_scale * CE_cap
        + ret_scale * (0.5 * CE_ret + (InfoNCE_t2i + InfoNCE_i2t) / 2)
        + gen_scale * (0.5 * CE_gen + mean L2(clip_emb, mapped))

The adapters are leaf tensors that require a gradient and are updated in
place; the frozen trees never require one (the step refuses them), so
autograd records nothing through their weights and the LM's backward
computes activation gradients only. No kernel has a backward: the LM's
attention and linear layers see inputs that need a gradient and take
their plain paths (ops/attention.py, nn/core.py, models/opt.py), while
the frozen CLIP tower runs its kernels.

The optimizer is gill_tpu's optax chain written out, with optax's
semantics where torch.optim's defaults differ:
  * the schedule reads the update count before incrementing it (with
    warmup, the first update uses lr(0) = 0);
  * clip_by_global_norm scales by max / norm only when norm >= max, no
    epsilon;
  * AdamW's decoupled decay applies to every leaf (logit_scale too), eps
    outside the square root, the bias corrections in fp32;
  * grad_accumulation_steps k > 1 is optax.MultiSteps: a running mean of k
    mini-step gradients, the inner optimizer (and its count) advancing
    only when it is applied; the renorm runs every mini-step.
`metrics["lr"]` is the schedule at `state.step` (every mini-step counts).

Data parallelism (`core.mesh` with data ranks) keeps gill_tpu's
global-batch semantics, not DDP's per-rank ones: each rank feeds its rows
of one global batch; the token CEs are the global batch's valid-token sum
over its global count (each rank's `ce_loss` is its share), the L2 and
the norms are global means, the contrastive matrices are the global
batch's (`gather_data`), and the accuracies count over the global batch.
The adapters' gradients are summed over "data" (each rank's loss holds
its shares and the whole contrastive term, whose gathered backward gives
each rank its own rows' part), so clipping, AdamW, MultiSteps and the
renorm then run identically on every rank. A concat-packed step packs the
global batch's pairs (2i, 2i+1) as gill_tpu does; where a rank holds an
odd count of rows, one pair spans two ranks, so the ranks first pass
their boundary rows (`pair_rows`) and then hold whole pairs in unequal
counts, which the means, the L2 share and the contrastive gathers weight
by each rank's share of the global rows. Under tensor parallelism the
LM's forward goes through the "model" collectives (models/opt.py), so
activation gradients reach the adapters whole.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from gill_tpu_torch.config import TrainConfig
from gill_tpu_torch.models.gill import GILLCore
from gill_tpu_torch.nn.core import tree_leaves, tree_map
from gill_tpu_torch.parallel.collectives import (data_group,
                                                 exchange_first_rows,
                                                 gather_data, global_count,
                                                 sum_over_data)
from gill_tpu_torch.train import losses as L

BATCH_KEYS = ("pixels", "ret_tokens", "ret_len", "gen_tokens", "gen_len",
              "clip_emb")


@dataclasses.dataclass
class TrainState:
    """adapters: leaf tensors with requires_grad, updated in place;
    opt_state: the optimizer's tensors and counts (`init_opt_state`);
    step: the number of steps taken (mini-steps under accumulation)."""
    adapters: dict
    opt_state: dict
    step: int = 0


def lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """Linear warmup from 0 to tc.lr over lr_warmup_steps, then a staircase
    decay by lr_schedule_gamma every lr_schedule_step_size *
    steps_per_epoch steps (reference main.py:342-344; gill_tpu's
    optax.join_schedules of linear_schedule and exponential_decay)."""
    warm = tc.lr_warmup_steps
    period = tc.lr_schedule_step_size * tc.steps_per_epoch

    def schedule(step: int) -> float:
        step = int(step)
        if step < warm:
            frac = 1.0 - min(max(step, 0), warm) / warm
            return -tc.lr * frac + tc.lr
        d = step - warm
        if period <= 0 or d <= 0:
            return float(tc.lr)
        return tc.lr * tc.lr_schedule_gamma ** math.floor(d / period)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def init_opt_state(tc: TrainConfig, adapters) -> dict:
    """AdamW moments (zeros like each adapter leaf) and the update count;
    under grad accumulation also the running gradient mean and the
    mini-step count (optax.MultiSteps' state)."""
    zeros = lambda: tree_map(lambda x: torch.zeros_like(x.detach()),
                             adapters)
    state = {"mu": zeros(), "nu": zeros(), "count": 0}
    if tc.grad_accumulation_steps > 1:
        state.update(acc=zeros(), mini_step=0)
    return state


def init_state(tc: TrainConfig, adapters) -> TrainState:
    """Copies of the adapters (the caller's tree is not updated) as leaf
    tensors that require a gradient, and a fresh optimizer state."""
    adapters = tree_map(
        lambda x: x.detach().clone().requires_grad_(True), adapters)
    return TrainState(adapters=adapters,
                      opt_state=init_opt_state(tc, adapters), step=0)


@torch.no_grad()
def _adamw(tc: TrainConfig, schedule, opt: dict, params, grads):
    """clip_by_global_norm + adamw on lists of tensors, in place."""
    if tc.grad_clip > 0:
        norm = global_norm(grads)
        keep = norm < tc.grad_clip
        grads = [torch.where(keep, g, (g / norm.to(g.dtype)) * tc.grad_clip)
                 for g in grads]
    count = opt["count"] + 1
    # the bias corrections 1 - b ** count in fp32, as optax computes them
    bc1 = float(1 - torch.tensor(tc.beta1, dtype=torch.float32) ** count)
    bc2 = float(1 - torch.tensor(tc.beta2, dtype=torch.float32) ** count)
    lr = schedule(opt["count"])
    for p, g, mu, nu in zip(params, grads, tree_leaves(opt["mu"]),
                            tree_leaves(opt["nu"])):
        mu.copy_((1 - tc.beta1) * g + tc.beta1 * mu)
        nu.copy_((1 - tc.beta2) * g * g + tc.beta2 * nu)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8)
        if tc.weight_decay:
            u = u + tc.weight_decay * p
        p.add_((-lr * u).to(p.dtype))
    opt["count"] = count


@torch.no_grad()
def apply_gradients(tc: TrainConfig, state: TrainState, grads,
                    schedule) -> None:
    """The optimizer's update of state.adapters from `grads` (a list in
    tree_leaves order), in place; MultiSteps under accumulation."""
    opt = state.opt_state
    params = tree_leaves(state.adapters)
    k = tc.grad_accumulation_steps
    if k <= 1:
        _adamw(tc, schedule, opt, params, grads)
        return
    acc = tree_leaves(opt["acc"])
    n = opt["mini_step"]
    for a, g in zip(acc, grads):
        a.copy_(a + (g - a) / (n + 1))
    if n == k - 1:
        _adamw(tc, schedule, opt, params, acc)
        for a in acc:
            a.zero_()
        opt["mini_step"] = 0
    else:
        opt["mini_step"] = n + 1


def pair_counts(n: int, dp: int) -> List[int]:
    """Rows each data rank holds in a concat-packed step when each loads n
    of the global batch's dp n: pair (2i, 2i+1) belongs to the rank that
    loaded row 2i, so rank r holds rows [e(r n), e((r + 1) n)), e(k) = k
    rounded up to even."""
    def even(k):
        return k + k % 2

    return [even((r + 1) * n) - even(r * n) for r in range(dp)]


def pair_rows(batch, mesh) -> Tuple[dict, List[int]]:
    """This data rank's rows of whole pairs of the global batch, from its
    loaded rows (n of them, odd): the first row goes to the rank before
    where it is the second of a pair, and the next rank's first row is
    appended where this rank's last row starts one. Returns the batch and
    `pair_counts(n, dp)`. Every data rank calls it (a collective)."""
    n, r = batch["pixels"].shape[0], mesh.dp_rank
    send, receive = (r * n) % 2 == 1, ((r + 1) * n) % 2 == 1
    out = {k: exchange_first_rows(v, mesh, send, receive)
           for k, v in batch.items()}
    return out, pair_counts(n, mesh.dp)


def compute_losses(core: GILLCore, params, batch, tc: TrainConfig,
                   concat_captions: bool, prefix_ids=None
                   ) -> Tuple[torch.Tensor, Dict]:
    """Runs the three modes and combines their losses; returns (loss,
    metrics), the metrics detached 0-d tensors plus "_viz" (the predicted
    caption tokens and the batch's retrieval argmaxes for the TB grids,
    reference main.py:675-720). Under data parallelism the returned loss
    is this rank's part (see the module docstring) and the metrics are the
    global batch's."""
    mesh = core.mesh
    dp = 1 if data_group(mesh) is None else mesh.dp
    counts = None
    if concat_captions and dp > 1 and batch["pixels"].shape[0] % 2:
        batch, counts = pair_rows(batch, mesh)
    pixels = batch["pixels"]
    # this rank's share of the global batch's rows
    share = 1.0 / dp if counts is None else \
        counts[mesh.dp_rank] / sum(counts)
    metrics: Dict = {}

    cap = core.forward(params, pixels, batch["ret_tokens"], batch["ret_len"],
                       mode="captioning", concat_captions=concat_captions,
                       prefix_ids=prefix_ids, remat=tc.remat)
    ce_cap = cap["ce_loss"] * tc.cap_loss_scale
    total = ce_cap
    with torch.no_grad():
        top1, top5 = L.token_accuracy(cap["logits"][:, :-1],
                                      cap["full_labels"][:, 1:], mesh=mesh)
        nv = core.cfg.n_visual_tokens
        viz = {"pred_tokens": torch.argmax(
            cap["logits"][:, max(nv - 1, 0):-1], dim=-1).int()}
    metrics.update(cap_ce=ce_cap, cap_top1=top1, cap_top5=top5,
                   vis_norm_cap=cap["visual_embs_norm"],
                   inp_norm=cap["input_embs_norm"])
    del cap

    ret = core.forward(params, pixels, batch["ret_tokens"], batch["ret_len"],
                       mode="retrieval", concat_captions=concat_captions,
                       prefix_ids=prefix_ids, remat=tc.remat)
    ce_ret = ret["ce_loss"] * tc.ret_loss_scale * 0.5
    # the global batch's matrices (reference main.py:522-535)
    logits_per_image = (gather_data(ret["visual_embs"], mesh, counts)
                        @ gather_data(ret["last_embedding"], mesh,
                                      counts).t())
    logits_per_text = logits_per_image.t()
    cont = (L.contrastive_loss(logits_per_text)
            + L.contrastive_loss(logits_per_image)) / 2.0
    total = total + ce_ret + tc.ret_loss_scale * cont
    with torch.no_grad():
        t2i1, t2i5 = L.contrastive_acc(logits_per_text, topk=(1, 5))
        i2t1, i2t5 = L.contrastive_acc(logits_per_image, topk=(1, 5))
        nb = pixels.shape[0]
        viz["t2i_idx"] = torch.argmax(logits_per_text[:nb, :nb], -1).int()
        viz["i2t_idx"] = torch.argmax(logits_per_image[:nb, :nb], -1).int()
    metrics.update(ret_ce=ce_ret, cont_loss=cont, t2i_top1=t2i1,
                   t2i_top5=t2i5, i2t_top1=i2t1, i2t_top5=i2t5,
                   vis_norm_ret=ret["visual_embs_norm"])
    del ret

    gen = core.forward(params, pixels, batch["gen_tokens"], batch["gen_len"],
                       mode="generation", concat_captions=concat_captions,
                       prefix_ids=prefix_ids, remat=tc.remat)
    ce_gen = gen["ce_loss"] * tc.gen_loss_scale * 0.5
    mapped = gen["last_embedding"]
    clip_emb = batch["clip_emb"].to(mapped.dtype)
    if mapped.shape != clip_emb.shape:
        mapped = mapped.reshape(clip_emb.shape)
    gen_l2 = L.l2_loss(clip_emb.float(), mapped.float()).mean() * share \
        * tc.gen_loss_scale
    total = total + ce_gen + gen_l2
    metrics.update(gen_ce=ce_gen, gen_l2=gen_l2, loss=total)
    metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
    if dp > 1:
        metrics = _global_metrics(metrics, tc, share, mesh)
    metrics["_viz"] = viz
    return total, metrics


_SHARES = ("cap_ce", "ret_ce", "gen_ce", "gen_l2")
_MEANS = ("vis_norm_cap", "inp_norm", "vis_norm_ret")


def _global_metrics(metrics, tc: TrainConfig, share: float, mesh) -> Dict:
    """The global batch's metrics from this rank's: the loss shares summed
    over "data" (one all-reduce), the per-rank means weighted by each
    rank's `share` of the rows, and the total rebuilt from them in
    gill_tpu's order."""
    keys = _SHARES + _MEANS
    vals = global_count(torch.stack(
        [metrics[k].float() * (share if k in _MEANS else 1.0)
         for k in keys]), mesh)
    out = dict(metrics)
    for i, k in enumerate(keys):
        out[k] = vals[i]
    out["loss"] = (out["cap_ce"] + out["ret_ce"]
                   + tc.ret_loss_scale * out["cont_loss"] + out["gen_ce"]
                   + out["gen_l2"])
    return out


def _check_frozen(frozen) -> None:
    if any(x.requires_grad for x in tree_leaves(frozen)
           if torch.is_tensor(x)):
        raise ValueError("a frozen tree leaf requires grad; only the "
                         "adapters are trained")


def make_train_step(core: GILLCore, tc: TrainConfig, prefix_ids=None):
    """Returns step(state, frozen, batch, concat=False) -> (state,
    metrics). `frozen` = {"lm", "vision"}; `batch` holds device tensors
    (`put_batch`). The state's adapters and optimizer tensors are updated
    in place and the same state object is returned, its step advanced."""
    schedule = lr_schedule(tc)

    def step(state: TrainState, frozen, batch, concat: bool = False):
        _check_frozen(frozen)
        params = {"lm": frozen["lm"], "vision": frozen["vision"],
                  "adapters": state.adapters}
        with torch.enable_grad():
            loss, metrics = compute_losses(core, params, batch, tc, concat,
                                           prefix_ids)
            leaves = tree_leaves(state.adapters)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        grads = sum_over_data(grads, core.mesh)
        del loss
        with torch.no_grad():
            metrics["grad_norm"] = global_norm(grads)
            apply_gradients(tc, state, grads, schedule)
            img = state.adapters["img_embeddings"]
            img.copy_(core.renorm_img_embeddings(params)["adapters"][
                "img_embeddings"])
            metrics["img_emb_norm"] = torch.linalg.vector_norm(
                img.float(), dim=1).mean()
        metrics["lr"] = torch.tensor(schedule(state.step),
                                     dtype=torch.float32)
        state.step += 1
        return state, metrics

    return step


def make_eval_step(core: GILLCore, tc: TrainConfig, prefix_ids=None):
    """Returns eval(adapters, frozen, batch, concat=False) -> metrics,
    the three forwards with no gradient (so the kernels run)."""
    @torch.no_grad()
    def step(adapters, frozen, batch, concat: bool = False):
        params = {"lm": frozen["lm"], "vision": frozen["vision"],
                  "adapters": adapters}
        _, metrics = compute_losses(core, params, batch, tc, concat,
                                    prefix_ids)
        return metrics

    return step


def put_batch(batch, device, pixel_dtype: Optional[torch.dtype] = None):
    """A loader's numpy batch -> device tensors (the model's keys only):
    on CUDA through pinned host memory, without blocking the host. The
    pixels take `pixel_dtype` (the frozen trees' dtype, as the reference's
    trainer casts its images)."""
    device = torch.device(device)
    out = {}
    for k in BATCH_KEYS:
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        if device.type == "cuda":
            t = t.pin_memory()
        t = t.to(device, non_blocking=True)
        if k == "pixels" and pixel_dtype is not None:
            t = t.to(pixel_dtype)
        out[k] = t
    return out


def state_tree(state: TrainState) -> dict:
    """The checkpoint tree: gill_tpu's "adapters" keys and the port's own
    optimizer state (utils/ckpt.py save_checkpoint)."""
    return {"adapters": state.adapters, "opt_state": state.opt_state}


def state_from_tree(tree: dict, step: int, device) -> TrainState:
    """A TrainState from `state_tree`'s layout as `load_checkpoint` reads it
    back (numpy leaves; the counts as 0-d arrays)."""
    def tensor(x):
        return torch.from_numpy(np.array(x)).to(device)

    opt = {k: (int(v) if k in ("count", "mini_step") else tree_map(tensor, v))
           for k, v in tree["opt_state"].items()}
    adapters = tree_map(lambda x: tensor(x).requires_grad_(True),
                        tree["adapters"])
    return TrainState(adapters=adapters, opt_state=opt, step=int(step))
