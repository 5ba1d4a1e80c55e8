"""The collectives of one tensor-parallel decode step, counted as the ranks
issue them, and the time of one collective of each size on the backend
the ranks use (port of scripts/tp_collective_budget.py, which counts the
collectives of XLA's compiled program).

Each of `--tp` ranks builds `--model` (random weights from a seed, drawn
on the device and kept on the host; the engine moves only the rank's
shard there), a `DecodeEngine(mesh=)` over a (1, tp) mesh with `--batch`
slots in a steady state at half of `--max-seq`, and runs one decode step
(a chunk of one: the forward, the fp32 head, the argmax) inside
`parallel.collectives.record_collectives()`. It reports every collective
by kind, dtype, bytes a rank hands in and count, the MB a step and a
token, and beside each size the mean ms of `--reps` such collectives
alone on the "model" group, the host's clock around device
synchronisations (gloo stages CUDA tensors through the host: ranks that
share one card take gloo; NCCL where each rank has a card of its own),
with the step's own ms. It also checks that the step's logits and tokens
are the same with the recorder open. No cost model is applied.

    python -m gill_tpu_torch.scripts.tp_collective_budget
        [--model facebook/opt-6.7b] [--tp 2] [--batch 8] [--max-seq 128]
        [--layers N] [--reps 20] [--device cuda] [--out PATH]

On the card it prints nvidia-smi's name and power limit first; it writes
nothing without --out.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from gill_tpu_torch.models import opt as opt_mod
from gill_tpu_torch.nn.core import Init
from gill_tpu_torch.parallel.collectives import record_collectives
from gill_tpu_torch.scripts import _serving as S
from gill_tpu_torch.serve.engine import DecodeEngine

MODEL = "facebook/opt-6.7b"


class HostInit(Init):
    """Each leaf drawn on the generator's device and copied to the host
    (the device holds one leaf at a time)."""

    def uniform(self, *a, **k):
        return super().uniform(*a, **k).cpu()

    def normal(self, *a, **k):
        return super().normal(*a, **k).cpu()

    def full(self, *a, **k):
        return super().full(*a, **k).cpu()


def host_tree(model, device, dtype, layers=None, seed: int = 0):
    """(params on the host, cfg): `model` (a preset or an OPTConfig) with
    `layers` of its layers, random from `seed` drawn on `device`."""
    cfg = S.opt_cfg(model)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    g = torch.Generator(device).manual_seed(seed)
    return opt_mod.init(HostInit(g, device, dtype), cfg), cfg


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _ms(fn, device, reps: int) -> float:
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return 1e3 * (time.perf_counter() - t0) / reps


def _one_collective(kind: str, dtype: str, nbytes: int, group, device):
    """A callable issuing one collective of `kind` over `group` on a
    tensor of `nbytes` bytes of `dtype`."""
    dt = getattr(torch, dtype)
    t = torch.zeros(nbytes // torch.empty((), dtype=dt).element_size(),
                    dtype=dt, device=device)
    if kind == "all_reduce":
        return lambda: dist.all_reduce(t, group=group)
    if kind == "broadcast":
        src = dist.get_global_rank(group, 0)
        return lambda: dist.broadcast(t, src=src, group=group)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    return lambda: dist.all_gather(parts, t, group=group)


@torch.no_grad()
def measure(params, cfg, mesh, device, *, batch: int = 8,
            max_seq: int = 128, reps: int = 20) -> dict:
    """One decode step of a tensor-parallel engine over `mesh` with the
    recorder open; every rank of the mesh calls it. `params`: the full
    tree (on the host or the device); the engine keeps this rank's shard
    on `device`."""
    dtype = params["embed_tokens"]["weight"].dtype
    eng = DecodeEngine(params, cfg, slots=batch, max_seq=max_seq, chunk=1,
                       prefill_buckets=(max_seq,), kv_dtype=dtype,
                       mesh=mesh, device=device)
    pos = max_seq // 2

    def step():
        S.steady_lm(eng, pos)
        return eng._chunk(max_seq)

    def logits():
        S.steady_lm(eng, pos)
        st = eng._dstate
        emb = opt_mod.embed_tokens(eng.params, st["tok"][:, None].long())
        return opt_mod.forward(eng.params, cfg, emb, cache=eng.cache,
                               cache_pos=st["pos"], lm_head=eng._head,
                               mesh=mesh)["logits"][:, -1]

    want_tok, want_logits = step().cpu(), logits().cpu()
    with record_collectives() as rec:
        got_tok = step().cpu()
    with record_collectives():
        got_logits = logits().cpu()
    step_ms = _ms(step, device, reps)
    rows = rec.rows()
    group = mesh.model
    for r in rows:
        r["ms"] = _ms(_one_collective(r["kind"], r["dtype"], r["bytes"],
                                      group, device), device, reps) \
            if group is not None else None
    nbytes = sum(r["bytes"] * r["count"] for r in rows)
    rep = {"tp": mesh.tp, "batch": batch, "max_seq": max_seq,
           "layers": cfg.num_layers, "hidden": cfg.hidden_size,
           "dtype": str(dtype).split(".")[-1],
           "backend": None if group is None else str(dist.get_backend(group)),
           "rows": rows, "collectives": rec.total(),
           "all_reduces": rec.total("all_reduce"),
           "mb_a_step": nbytes / 1e6, "mb_a_token": nbytes / 1e6 / batch,
           "step_ms": step_ms,
           "collective_ms_a_step": None if group is None else sum(
               r["ms"] * r["count"] for r in rows),
           "tokens_equal_with_recorder": torch.equal(got_tok, want_tok),
           "logits_equal_with_recorder": torch.equal(got_logits,
                                                     want_logits)}
    del eng
    return rep


def rank_main(model: str = MODEL, layers=None, batch: int = 8,
              max_seq: int = 128, reps: int = 20, seed: int = 0,
              device: str = "cuda") -> dict:
    """A rank of `main`'s group (`parallel.launch.run_ranks`)."""
    from gill_tpu_torch.parallel import create_mesh

    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.device(device).type == "cuda" else torch.device("cpu")
    mesh = create_mesh(1, dist.get_world_size())
    params, cfg = host_tree(model, dev, S.act_dtype(dev), layers, seed)
    rep = measure(params, cfg, mesh, dev, batch=batch, max_seq=max_seq,
                  reps=reps)
    rep["model"] = model
    return rep


def print_report(rep: dict) -> None:
    print(f"model={rep.get('model')} tp={rep['tp']} batch={rep['batch']} "
          f"(one decode step, {rep['layers']} layers, hidden "
          f"{rep['hidden']}, {rep['dtype']}; backend {rep['backend']})",
          flush=True)
    for r in rep["rows"]:
        ms = "not measured" if r["ms"] is None else f"{r['ms']:.4f} ms each"
        print(f"  {r['kind']:<11} {r['dtype']:<9} {r['bytes']:>10} B "
              f"x {r['count']:<4} {ms}", flush=True)
    total = rep["collective_ms_a_step"]
    print(f"  TOTAL {rep['collectives']} collectives, {rep['mb_a_step']:.3f}"
          f" MB a step ({rep['mb_a_token']:.4f} MB a token); "
          f"{'n/a' if total is None else f'{total:.2f}'} ms of collectives "
          f"alone against a step of {rep['step_ms']:.2f} ms", flush=True)


def main(argv=None) -> int:
    from gill_tpu_torch.parallel.launch import run_ranks
    from gill_tpu_torch.scripts._timing import smi_line

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=MODEL)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--layers", type=int)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write every rank's report here")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        print(smi_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        reps = run_ranks(
            "gill_tpu_torch.scripts.tp_collective_budget:rank_main", args.tp,
            {"model": args.model, "layers": args.layers,
             "batch": args.batch, "max_seq": args.max_seq,
             "reps": args.reps, "device": args.device},
            workdir=tmp, timeout=1800, device=args.device, threads=4)
    print_report(reps[0])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(reps, f, indent=1)
    ok = all(r["tokens_equal_with_recorder"] and
             r["logits_equal_with_recorder"] for r in reps)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
