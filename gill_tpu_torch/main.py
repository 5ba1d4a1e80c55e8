"""GILL training CLI on PyTorch (counterpart of the repository's main.py).

    python -m gill_tpu_torch.main --dataset-dir datasets --image-dir data/ \
        --exp-name run1 --precision bf16 --batch-size 32

The flags, loss recipe and logging surface of main.py (the reference
trainer's): build the tokenizer with the [IMG] tokens, load the frozen OPT
and CLIP (random weights where no local files are found), init the
adapters, then train with periodic validation, TensorBoard scalars and
image grids, and `ckpt/` + `ckpt_best/` checkpoints. It differs from
main.py in these ways:
  * `--device` (default cuda) replaces `--platform`; with no card and no
    `--device cpu` it raises;
  * several ranks are several processes, started by torch.distributed.run
    (one per card; ranks that share a card, or the CPU, take gloo):

        python -m torch.distributed.run --nproc-per-node 2 \
            -m gill_tpu_torch.main ... --dp-size 2 --ckpt-backend orbax

    The world size must be dp x tp after DP shrinks to divide the batch
    (main.py's rule); a mismatch raises. `--multihost` asks for the
    launcher's environment and raises without it. Each rank loads
    batch_size / dp rows (its data coordinate's shard); rank 0 makes the
    log directory and broadcasts its path, and alone writes TensorBoard,
    args.json and the npz checkpoints; `--ckpt-backend orbax` writes
    `orbax_<step>/` collectively with torch.distributed.checkpoint (not
    orbax's format). With concat_captions a step packs pairs of a rank's
    own rows, so it needs an even count of rows a rank;
  * `--profile-steps N` writes a torch.profiler trace of N steps to
    `<log dir>/trace/`;
  * fp32 products stay fp32 (TF32 off).
`main(argv)` returns the run's log directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

def parse_args(argv):
    p = argparse.ArgumentParser(description="GILL training (PyTorch)")
    p.add_argument("--opt-version", default="facebook/opt-6.7b")
    p.add_argument("--visual-model", default="openai/clip-vit-large-patch14")
    p.add_argument("--num-tokens", default=8, type=int)
    p.add_argument("--num-clip-tokens", default=77, type=int)
    p.add_argument("-d", "--dataset", default="cc3m")
    p.add_argument("--val-dataset", default="cc3m")
    p.add_argument("--dataset-dir", default="datasets")
    p.add_argument("--image-dir", default="data/")
    p.add_argument("--log-base-dir", default="./runs")
    p.add_argument("--exp-name", default="gill_tpu")
    p.add_argument("-j", "--workers", default=2, type=int)
    p.add_argument("--epochs", default=10, type=int)
    p.add_argument("--steps-per-epoch", dest="steps_per_epoch", default=2000,
                   type=int)
    p.add_argument("--steps_per_epoch", dest="steps_per_epoch", type=int,
                   help=argparse.SUPPRESS)
    p.add_argument("--start-epoch", default=0, type=int)
    p.add_argument("--val-steps-per-epoch", dest="val_steps_per_epoch",
                   default=-1, type=int)
    p.add_argument("--val_steps_per_epoch", dest="val_steps_per_epoch",
                   type=int, help=argparse.SUPPRESS)
    p.add_argument("-b", "--batch-size", default=200, type=int)
    p.add_argument("--val-batch-size", default=None, type=int)
    p.add_argument("--lr", "--learning-rate", default=1e-3, type=float)
    p.add_argument("--lr-warmup-steps", default=2000, type=int)
    p.add_argument("--lr-schedule-step-size", dest="lr_schedule_step_size",
                   default=5, type=int)
    p.add_argument("--lr-schedule-gamma", dest="lr_schedule_gamma",
                   default=0.1, type=float)
    p.add_argument("--grad-accumulation-steps", default=1, type=int)
    p.add_argument("--grad-clip", default=1.0, type=float)
    p.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--frozen-lm-precision", default=None,
                   choices=["bf16", "fp32", "w8"],
                   help="override the frozen LM's precision; 'w8' stores "
                        "the frozen decoder as per-channel int8 (the "
                        "training forward takes its dequant form, so "
                        "gradients reach the adapters)")
    p.add_argument("--cap-loss-scale", default=1.0, type=float)
    p.add_argument("--ret-loss-scale", default=1.0, type=float)
    p.add_argument("--gen-loss-scale", default=1.0, type=float)
    p.add_argument("--concat-captions-prob", default=0.5, type=float)
    p.add_argument("--input-prompt", default="A picture of")
    p.add_argument("--image-size", default=224, type=int)
    p.add_argument("--ret-emb-dim", default=256, type=int)
    p.add_argument("--gen-emb-dim", default=768, type=int)
    p.add_argument("--text-fc-mode", default="gill_mapper",
                   choices=["linear", "gill_mapper"])
    p.add_argument("--ret-text-fc-mode", default="linear",
                   choices=["linear", "gill_mapper"])
    p.add_argument("--max-len", default=32, type=int)
    p.add_argument("--n-visual-tokens", default=4, type=int)
    p.add_argument("--beta1", default=0.9, type=float)
    p.add_argument("--beta2", default=0.95, type=float)
    p.add_argument("--wd", "--weight-decay", dest="weight_decay",
                   default=0.01, type=float)
    p.add_argument("-p", "--print-freq", default=10, type=int)
    p.add_argument("--resume", default="", type=str)
    p.add_argument("-e", "--evaluate", action="store_true")
    p.add_argument("--seed", default=None, type=int)
    p.add_argument("--dp-size", default=-1, type=int,
                   help="data-parallel size (-1: world size / tp)")
    p.add_argument("--tp-size", default=1, type=int,
                   help="tensor-parallel size of the frozen LM")
    p.add_argument("--remat", action="store_true",
                   help="recompute each frozen-LM layer in the backward "
                        "instead of keeping its activations")
    p.add_argument("--weights-dir", default=None,
                   help="root dir with local HF checkpoints for the frozen "
                        "backbones (else $GILL_TPU_WEIGHTS_DIR, else random)")
    p.add_argument("--tokenizer-dir", default=None,
                   help="dir with vocab.json/merges.txt (else "
                        "$GILL_TPU_TOKENIZER_DIR, else tiny byte-level)")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda raises when no card is present")
    p.add_argument("--profile-steps", default=0, type=int,
                   help="write a torch.profiler trace of N steps, from the "
                        "run's second step on")
    p.add_argument("--multihost", action="store_true",
                   help="require torch.distributed.run's environment")
    p.add_argument("--ckpt-backend", default="npz", choices=("npz", "orbax"),
                   help="npz (rank 0) or the collective orbax_<step>/ "
                        "checkpoint (torch.distributed.checkpoint)")
    return p.parse_args(argv)


def dump_git_status(out_path: str):
    """Run provenance (reference utils.py:16-21); empty where git or the
    repository is missing."""
    with open(out_path, "w") as f:
        for cmd in ("git rev-parse HEAD", "git --no-pager diff --stat"):
            try:
                f.write(subprocess.run(cmd.split(), capture_output=True,
                                       text=True).stdout)
            except OSError:
                pass


def build_tokenizer(args):
    from gill_tpu_torch.tokenizer import (GPT2BPETokenizer, load_tokenizer,
                                          setup_gill_tokenizer)

    try:
        tok = load_tokenizer(args.tokenizer_dir or args.opt_version)
    except FileNotFoundError:
        print("WARNING: no tokenizer assets found; using tiny byte-level "
              "tokenizer (fine for smoke runs).", flush=True)
        tok = GPT2BPETokenizer.tiny()
    img_ids = setup_gill_tokenizer(tok, args.num_tokens)
    if img_ids != list(range(img_ids[0], img_ids[0] + args.num_tokens)):
        raise ValueError(f"[IMG] ids are not one run: {img_ids}")
    return tok, img_ids


def make_log_dir(args) -> str:
    """A fresh `<log_base_dir>/<exp_name>[_i]` (makedirs is the claim;
    reference main.py:176-188); rank 0 calls it."""
    log_dir = os.path.join(args.log_base_dir, args.exp_name)
    i = 1
    while True:
        try:
            os.makedirs(log_dir)
            return log_dir
        except FileExistsError:
            log_dir = os.path.join(args.log_base_dir, f"{args.exp_name}_{i}")
            i += 1


def _write_grids(writer, tokenizer, batch, viz, step: int):
    """The train caption grid (input | GT | predicted caption) and the
    t2i / i2t retrieval mosaics (reference main.py:675-720)."""
    from gill_tpu_torch.utils.image import CLIP_MEAN, CLIP_STD, caption_grid

    nshow = 16
    px = np.clip(np.asarray(batch["pixels"], np.float32) * CLIP_STD
                 + CLIP_MEAN, 0, 1)
    gt_caps = [tokenizer.decode(row) for row in batch["ret_tokens"]]
    pred_caps = [tokenizer.decode(row)
                 for row in viz["pred_tokens"][:nshow].cpu().numpy()]
    if len(pred_caps) < len(px):
        # a concat-packed step: each row covers two examples
        # (reference main.py:697-699)
        pred_caps = [c for c in pred_caps for _ in (0, 1)]
    grid = caption_grid(px[:nshow], gt_caps[:nshow], pred_caps[:nshow])
    writer.add_image("train/images_gen_cap", grid.transpose(2, 0, 1), step)
    t2i = viz["t2i_idx"].cpu().numpy() % len(px)
    grid = caption_grid(px[t2i[:nshow]], gt_caps[:nshow], None)
    writer.add_image("train/t2i_ret", grid.transpose(2, 0, 1), step)
    i2t = viz["i2t_idx"].cpu().numpy() % len(gt_caps)
    grid = caption_grid(px[:nshow], [gt_caps[j] for j in i2t[:nshow]], None)
    writer.add_image("train/i2t_ret", grid.transpose(2, 0, 1), step)


def mesh_shape(batch_size: int, dp_size: int, tp_size: int,
               world: int) -> tuple:
    """(dp, tp) for `world` ranks: dp = dp_size, or world / tp when -1,
    shrunk until it divides the batch (main.py:273-281); the world must
    then be dp x tp."""
    tp = max(1, tp_size)
    if tp > world:
        raise SystemExit(f"--tp-size {tp} exceeds the {world} rank(s)")
    dp = dp_size if dp_size > 0 else world // tp
    while dp > 1 and (batch_size % dp != 0 or dp * tp > world):
        dp -= 1
    if dp * tp != world:
        raise SystemExit(f"{world} rank(s) for a ({dp}, {tp}) mesh: start "
                         f"dp x tp = {dp * tp} ranks")
    return dp, tp


def main(argv) -> str:
    args = parse_args(argv)

    import torch
    import torch.distributed as dist

    from gill_tpu_torch.config import GILLConfig, TrainConfig
    from gill_tpu_torch.data.dataset import DataLoader, get_dataset
    from gill_tpu_torch.models import opt as opt_mod
    from gill_tpu_torch.models.gill import GILLCore
    from gill_tpu_torch.nn.core import Init, tree_leaves, tree_map
    from gill_tpu_torch.parallel import create_mesh, init_distributed
    from gill_tpu_torch.parallel.collectives import broadcast_str
    from gill_tpu_torch.parallel.mesh import launched
    from gill_tpu_torch.parallel.partition import replicated, shard_params
    from gill_tpu_torch.train import trainer as trainer_mod
    from gill_tpu_torch.train import validate as validate_mod
    from gill_tpu_torch.utils import ckpt as ckpt_utils
    from gill_tpu_torch.utils.meters import AverageMeter, ProgressMeter
    from gill_tpu_torch.utils.tb import SummaryWriter
    from gill_tpu_torch.weights import loader as wloader

    if args.multihost and not (launched() or dist.is_initialized()):
        raise SystemExit("--multihost needs torch.distributed.run's "
                         "environment (RANK, WORLD_SIZE, ...)")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to train on the CPU")
    dev = init_distributed(dev)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dp, tp = mesh_shape(args.batch_size, args.dp_size, args.tp_size, world)

    # rank 0 claims the log directory and broadcasts its path (the orbax
    # backend saves collectively, so every rank needs it; main.py:175-201)
    log_dir = make_log_dir(args) if rank0 else None
    log_dir = broadcast_str(log_dir)
    if rank0:
        with open(os.path.join(log_dir, "args.json"), "w") as f:
            json.dump(vars(args), f, indent=4)
        dump_git_status(os.path.join(log_dir, "git_info.txt"))
        print(f"Logging to {log_dir}.", flush=True)
    mesh = create_mesh(dp, tp)
    print(f"Mesh: {mesh}", flush=True)
    if args.seed is not None:
        np.random.seed(args.seed)
        torch.manual_seed(args.seed)

    # ---- tokenizer + [IMG] tokens (reference main.py:255-280) ----
    tokenizer, img_ids = build_tokenizer(args)

    # ---- model config; persist model_args.json (main.py:283-284) ----
    cfg = GILLConfig(
        opt_version=args.opt_version, visual_encoder=args.visual_model,
        n_visual_tokens=args.n_visual_tokens, ret_emb_dim=args.ret_emb_dim,
        gen_emb_dim=args.gen_emb_dim, text_fc_mode=args.text_fc_mode,
        ret_text_fc_mode=args.ret_text_fc_mode, num_tokens=args.num_tokens,
        num_clip_tokens=args.num_clip_tokens, max_len=args.max_len,
        retrieval_token_idx=tuple(img_ids), gen_token_idx=tuple(img_ids),
        image_size=args.image_size)
    cfg.to_json(os.path.join(log_dir, "model_args.json"))
    core = GILLCore.build(cfg, vocab_len=len(tokenizer), img_start=img_ids[0],
                          pad_token_id=tokenizer.pad_token_id,
                          bos_token_id=tokenizer.bos_token_id, mesh=mesh)
    if args.frozen_lm_precision == "w8" and tp > 1:
        raise SystemExit("--frozen-lm-precision w8 is a single-chip/DP "
                         "memory lever; use bf16 with --tp-size>1")

    tc = TrainConfig(
        epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        val_steps_per_epoch=args.val_steps_per_epoch,
        batch_size=args.batch_size, val_batch_size=args.val_batch_size,
        lr=args.lr, lr_warmup_steps=args.lr_warmup_steps,
        lr_schedule_step_size=args.lr_schedule_step_size,
        lr_schedule_gamma=args.lr_schedule_gamma,
        grad_accumulation_steps=args.grad_accumulation_steps,
        grad_clip=args.grad_clip, precision=args.precision,
        cap_loss_scale=args.cap_loss_scale, ret_loss_scale=args.ret_loss_scale,
        gen_loss_scale=args.gen_loss_scale,
        concat_captions_prob=args.concat_captions_prob,
        input_prompt=args.input_prompt, max_len=args.max_len,
        beta1=args.beta1, beta2=args.beta2, weight_decay=args.weight_decay,
        print_freq=args.print_freq, seed=args.seed,
        dp_size=args.dp_size, tp_size=args.tp_size, remat=args.remat)

    # ---- frozen backbones (never require grad) + fp32 adapters ----
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    seed = args.seed or 0
    with torch.no_grad():
        lm = wloader.load_opt(args.opt_version, core.opt_cfg, len(tokenizer),
                              args.weights_dir, seed, device=dev, dtype=dtype)
        vision = wloader.load_clip_vision(args.visual_model, core.vis_cfg,
                                          args.weights_dir, seed + 1,
                                          device=dev, dtype=dtype)
        if args.frozen_lm_precision == "w8":
            lm = opt_mod.quantize_params_w8(
                tree_map(lambda x: x.to(torch.bfloat16), lm))
        elif args.frozen_lm_precision in ("bf16", "fp32"):
            lm_dtype = (torch.bfloat16 if args.frozen_lm_precision == "bf16"
                        else torch.float32)
            lm = tree_map(lambda x: x.to(lm_dtype), lm)
        frozen = {"lm": lm, "vision": vision}
        del lm, vision
        if tp > 1:
            # each rank keeps its shard of the LM's matrices
            frozen = shard_params(frozen, mesh)
        g = torch.Generator(dev).manual_seed(seed)
        # every rank draws the same adapters; `replicated` checks it
        adapters = replicated(core.init_adapters(Init(g, dev, torch.float32)),
                              mesh)

    def count(tree):
        return sum(x.numel() for x in tree_leaves(tree) if torch.is_tensor(x))

    report = (f"Trainable params: {count(adapters):,}\n"
              f"Frozen params:   {count(frozen):,}\n")
    print(report, flush=True)
    if rank0:
        with open(os.path.join(log_dir, "param_count.txt"), "w") as f:
            f.write(report)

    state = trainer_mod.init_state(tc, adapters)
    del adapters
    best_acc1 = -1.0
    if args.resume:
        if (args.ckpt_backend == "orbax"
                or ckpt_utils.latest_orbax_step(args.resume) is not None):
            tree, meta = ckpt_utils.load_checkpoint_orbax(args.resume)
        else:
            tree, meta = ckpt_utils.load_checkpoint(args.resume)
        state = trainer_mod.state_from_tree(tree, meta["step"], dev)
        args.start_epoch = meta.get("epoch", 0)
        best_acc1 = meta.get("best_acc1", -1.0)
        print(f"Resumed from {args.resume} @ epoch {args.start_epoch}.")

    # ---- data ----
    train_ds = get_dataset(args, "train", tokenizer, img_ids)
    val_ds = get_dataset(args, "val", tokenizer, img_ids)
    print(f"Training with {len(train_ds)} examples, validating with "
          f"{len(val_ds)}.", flush=True)
    # each data coordinate loads its interleaved shard of the global batch
    # (the DistributedSampler equivalent; ranks of one model group load the
    # same rows)
    train_loader = DataLoader(train_ds, tc.batch_size // dp, shuffle=True,
                              seed=seed, num_threads=args.workers,
                              rank=mesh.dp_rank, world=dp)
    # drop_last=False: leftover val samples still count (the reference
    # uses an auxiliary loader for the sampler remainder,
    # validate.py:311-317)
    val_loader = DataLoader(val_ds, (tc.val_batch_size or tc.batch_size) // dp,
                            shuffle=False, num_threads=args.workers,
                            rank=mesh.dp_rank, world=dp, drop_last=False)
    prefix_ids = None
    if args.input_prompt:
        prefix_ids = torch.tensor(
            tokenizer(args.input_prompt, add_special_tokens=False).input_ids,
            dtype=torch.long, device=dev)

    writer = SummaryWriter(log_dir) if rank0 else None
    step_fn = trainer_mod.make_train_step(core, tc)

    def run_validate(epoch):
        return validate_mod.validate(
            core, tc, state.adapters, frozen, val_loader, tokenizer,
            epoch=epoch, writer=writer, prefix_ids=prefix_ids,
            max_steps=tc.val_steps_per_epoch, decode_captions=True,
            device=dev, pixel_dtype=dtype)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    try:
        if args.evaluate:
            run_validate(args.start_epoch)
            return log_dir
        prof = None
        for epoch in range(args.start_epoch, tc.epochs):
            if epoch == 0:
                run_validate(epoch - 1)
            train_loader.set_epoch(epoch)
            # a per-epoch concat-decision stream, so a resumed run replays
            # the decisions of its epochs (reference main.py:347-367)
            rng = np.random.RandomState(
                (seed + 1000003 * (epoch + 1)) % (2 ** 31))
            meters = {k: AverageMeter(k, ":.4e") for k in
                      ("loss", "cap_ce", "cont_loss", "gen_l2")}
            acc_meters = {k: AverageMeter(k, ":6.2f") for k in
                          ("cap_top1", "cap_top5", "t2i_top1", "i2t_top1")}
            batch_time = AverageMeter("time/batch", ":6.3f")
            data_time = AverageMeter("time/data", ":6.3f")
            progress = ProgressMeter(
                tc.steps_per_epoch,
                [batch_time, *meters.values(), *acc_meters.values()],
                prefix=f"Epoch: [{epoch}]")

            it = iter(train_loader)
            end = time.time()
            # the metric sums stay on the device; the host reads them once
            # a print window and logs the window's averages
            msum, mcount = None, 0
            win_t0 = time.time()
            for i in range(tc.steps_per_epoch):
                try:
                    batch = next(it)
                except StopIteration:
                    train_loader.set_epoch(epoch * 1000 + i)
                    it = iter(train_loader)
                    batch = next(it)
                data_time.update(time.time() - end)
                # the same draw on every rank; pairs are packed within a
                # rank's rows
                concat = bool(rng.uniform() < tc.concat_captions_prob) and \
                    ((tc.batch_size // dp) % 2 == 0)
                actual_step = epoch * tc.steps_per_epoch + i + 1
                run_step = ((epoch - args.start_epoch) * tc.steps_per_epoch
                            + i + 1)
                if args.profile_steps and run_step == 2:
                    acts = [torch.profiler.ProfilerActivity.CPU]
                    if dev.type == "cuda":
                        acts.append(torch.profiler.ProfilerActivity.CUDA)
                    prof = torch.profiler.profile(activities=acts)
                    prof.start()
                state, metrics = step_fn(
                    state, frozen,
                    trainer_mod.put_batch(batch, dev, dtype), concat=concat)
                viz = metrics.pop("_viz")
                msum = metrics if msum is None else {
                    k: msum[k] + v for k, v in metrics.items()}
                mcount += 1
                if prof is not None and run_step == 1 + args.profile_steps:
                    sync()
                    prof.stop()
                    os.makedirs(os.path.join(log_dir, "trace"),
                                exist_ok=True)
                    prof.export_chrome_trace(
                        os.path.join(log_dir, "trace", "trace.json"))
                    prof = None
                if actual_step == 1 or (i + 1) % tc.print_freq == 0:
                    if writer is not None:
                        _write_grids(writer, tokenizer, batch, viz,
                                     actual_step)
                    # float() waits for every step of the window, so the
                    # wall time over the steps is a true s a step
                    window = {k: float(v) / mcount for k, v in msum.items()}
                    batch_time.update((time.time() - win_t0) / mcount, mcount)
                    msum, mcount = None, 0
                    win_t0 = time.time()
                    for k, m in {**meters, **acc_meters}.items():
                        m.update(window[k], tc.batch_size)
                    progress.display(i + 1)
                    if writer is not None:
                        for k, v in window.items():
                            writer.add_scalar(f"train/{k}", v, actual_step)
                        writer.add_scalar(
                            "metrics/examples_per_sec",
                            tc.batch_size / max(batch_time.avg, 1e-9),
                            actual_step)
                        writer.add_scalar("metrics/total_secs_per_batch",
                                          batch_time.avg, actual_step)
                end = time.time()

            acc1 = run_validate(epoch)
            is_best = acc1 > best_acc1
            best_acc1 = max(acc1, best_acc1)
            meta = {"epoch": epoch + 1, "best_acc1": float(best_acc1)}
            if args.ckpt_backend == "orbax":
                # collective: every rank calls it
                ckpt_utils.save_checkpoint_orbax(
                    trainer_mod.state_tree(state), log_dir, step=state.step,
                    meta=meta)
                if is_best and rank0:
                    with open(os.path.join(log_dir, "orbax_best.json"),
                              "w") as f:
                        json.dump({"step": int(state.step), **meta}, f)
            elif rank0:
                ckpt_utils.save_checkpoint(
                    trainer_mod.state_tree(state), log_dir, step=state.step,
                    is_best=is_best, meta=meta)
    finally:
        if writer is not None:
            writer.close()
    return log_dir


if __name__ == "__main__":
    main(sys.argv[1:])
