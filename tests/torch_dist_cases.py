"""Rank functions for the distributed tests (tests/test_torch_dist_*.py).

`gill_tpu_torch.parallel.launch.run_ranks` runs each function on every
rank of a gloo group on the CPU. This module imports only torch, numpy
and gill_tpu_torch, so a rank never loads JAX: the test process computes
gill_tpu's reference itself and hands the ranks numpy inputs. Each
function returns numpy results that the test compares across ranks and
against the reference.
"""

from __future__ import annotations

import io
import os
from contextlib import redirect_stdout

import numpy as np
import torch
import torch.distributed as dist

from gill_tpu_torch import config as tcfg
from gill_tpu_torch.models.gill import GILLCore
from gill_tpu_torch.nn.core import tree_leaves, tree_map
from gill_tpu_torch.parallel import create_mesh
from gill_tpu_torch.parallel import collectives as C
from gill_tpu_torch.parallel import partition as P
from gill_tpu_torch.weights import from_jax

TESTS = os.path.dirname(os.path.abspath(__file__))


def run(target: str, world: int, tmp_path, timeout: float = 240.0,
        **kwargs):
    """`run_ranks` of `torch_dist_cases.<target>` on `world` CPU ranks in
    a fresh directory under `tmp_path` (its file store is the
    rendezvous); a group that fails or hangs raises."""
    from gill_tpu_torch.parallel.launch import run_ranks

    os.makedirs(str(tmp_path), exist_ok=True)
    workdir = os.path.join(str(tmp_path), f"{target}_{world}_"
                           f"{len(os.listdir(str(tmp_path)))}")
    return run_ranks(f"torch_dist_cases:{target}", world, kwargs,
                     workdir=workdir, timeout=timeout, device="cpu",
                     pg_timeout=120.0, pythonpath=[TESTS])


def make_core(core_kw, mesh=None) -> GILLCore:
    return GILLCore(cfg=tcfg.GILLConfig(**core_kw["cfg"]),
                    opt_cfg=tcfg.OPTConfig(**core_kw["opt"]),
                    vis_cfg=tcfg.CLIPVisionConfig(**core_kw["vis"]),
                    mesh=mesh, **core_kw["ids"])


def _np(tree):
    return from_jax.tree_to_numpy(tree)


def make_params(core_kw, seed: int):
    """The GILL parameters of `core_kw` from the port's init with `seed`,
    as numpy (gill_tpu's layout): every rank and the test process make the
    same tree, so none is pickled to the ranks."""
    from gill_tpu_torch.nn.core import Init

    return _np(make_core(core_kw).init_params(
        Init(torch.Generator().manual_seed(seed), "cpu")))


# ---------------------------------------------------------------------------
# partition and collectives
# ---------------------------------------------------------------------------

def partition_and_collectives(core_kw, seed: int, dp: int, tp: int):
    """shard -> gather round trip of a GILL tree, Megatron's pair and the
    data all-gather against their one-process values, `gather_rows` with
    ragged counts, `broadcast_str`, `AverageMeter.all_reduce`, and
    `replicated`'s check on a tree every rank holds and on one that differs
    on a rank."""
    from gill_tpu_torch.utils.meters import AverageMeter

    mesh = create_mesh(dp, tp)
    full = from_jax.gill_params_from_jax(make_params(core_kw, seed))
    shard = P.shard_params(full, mesh)
    back = P.gather_params(shard, mesh)
    out = {"coords": mesh.coords,
           "q_shape": tuple(shard["lm"]["layers"]["attn"]["q"]["w"].shape),
           "round_trip": all(torch.equal(a, b) for a, b in
                             zip(tree_leaves(full), tree_leaves(back)))}

    # y = relu(x W1) W2 over the model ranks' column / row shards, with
    # x entering through copy_to_model and the sum leaving through
    # reduce_from_model, against the whole product's value and gradients
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 8, generator=g, dtype=torch.float64)
    w1 = torch.randn(8, 12, generator=g, dtype=torch.float64)
    w2 = torch.randn(12, 5, generator=g, dtype=torch.float64)
    k = 12 // tp
    cols = slice(mesh.tp_rank * k, (mesh.tp_rank + 1) * k)
    xs = x.clone().requires_grad_(True)
    y = C.reduce_from_model(
        torch.relu(C.copy_to_model(xs, mesh) @ w1[:, cols]) @ w2[cols], mesh)
    (y * torch.arange(5.0, dtype=torch.float64)).sum().backward()
    xr = x.clone().requires_grad_(True)
    yr = torch.relu(xr @ w1) @ w2
    (yr * torch.arange(5.0, dtype=torch.float64)).sum().backward()
    out["tp_y_err"] = float((y - yr).abs().max())
    out["tp_grad_err"] = float((xs.grad - xr.grad).abs().max())

    # every data rank's rows gathered; the whole loss of the gathered rows
    # differentiated on each rank gives each its own rows' gradient
    rows = torch.randn(dp * 2, 4, generator=g, dtype=torch.float64)
    mine = rows[mesh.dp_rank * 2:(mesh.dp_rank + 1) * 2].clone() \
        .requires_grad_(True)
    allr = C.gather_data(mine, mesh)
    (allr.sin().sum() * (allr ** 2).sum()).backward()
    ref = rows.clone().requires_grad_(True)
    (ref.sin().sum() * (ref ** 2).sum()).backward()
    out["gather_err"] = float((allr - ref).abs().max())
    out["gather_grad_err"] = float(
        (mine.grad - ref.grad[mesh.dp_rank * 2:(mesh.dp_rank + 1) * 2])
        .abs().max())

    out["rows"] = C.gather_rows(np.arange(mesh.dp_rank + 1), mesh)
    out["str"] = C.broadcast_str("run_3" if mesh.rank == 0 else None)
    m = AverageMeter("x")
    m.update(float(mesh.rank + 1), n=mesh.rank + 2)
    m.all_reduce()
    out["meter"] = (m.sum, m.count, m.avg)

    out["replicated"] = P.replicated(full, mesh) is full
    odd = {"w": torch.full((3,), float(mesh.rank == 3))}
    try:
        P.replicated(odd, mesh)
        out["replicated_refused"] = None
    except RuntimeError as e:
        out["replicated_refused"] = str(e)
    return out


# ---------------------------------------------------------------------------
# tensor-parallel decoding and serving
# ---------------------------------------------------------------------------

def tp_serve(core_kw, seed: int, embs, num_words: int, trace, prefix,
             gill_cases, gill_prefix, engine_kw, gill_engine_kw):
    """GILLCore.generate, DecodeEngine(mesh=) with a registered prefix and
    GillDecodeEngine(mesh=) with an embedding prefix, at tp = world."""
    from gill_tpu_torch.serve.engine import DecodeEngine, ServeRequest
    from gill_tpu_torch.serve.gill_engine import (GillDecodeEngine,
                                                  GillServeRequest)

    mesh = create_mesh(1, dist.get_world_size())
    core = make_core(core_kw, mesh)
    full = from_jax.gill_params_from_jax(make_params(core_kw, seed))
    with torch.no_grad():
        out = core.generate(P.shard_params(full, mesh), torch.from_numpy(embs),
                            num_words=num_words, temperature=0.0)
    res = {"tokens": out["tokens"].numpy(), "hidden": out["hidden"].numpy(),
           "kv_heads": None}

    # the host tree with the rank's device named: only its shard is moved
    eng = DecodeEngine(full["lm"], core.opt_cfg, mesh=mesh, device="cpu",
                       kv_dtype=torch.float32, **engine_kw)
    res["kv_heads"] = eng.cache["k"].shape[3]
    pid = eng.register_prefix(prefix)
    reqs = [ServeRequest(uid=u, prompt=p, max_new_tokens=n,
                         prefix_id=pid if u % 2 else None)
            for u, p, n in trace]
    res["engine"] = eng.run(reqs)
    res["engine_pipelined"] = eng.run_pipelined(
        [ServeRequest(uid=u, prompt=p, max_new_tokens=n)
         for u, p, n in trace])

    geng = GillDecodeEngine(core, full, mesh=mesh, device="cpu",
                            kv_dtype=torch.float32, **gill_engine_kw)
    gpid = geng.register_prefix(gill_prefix)
    res["gill_engine"] = {
        u: {"tokens": r["tokens"], "img_runs": np.asarray(r["img_runs"])}
        for u, r in geng.run([GillServeRequest(prefix_id=gpid, **c)
                              for c in gill_cases]).items()}

    # one decode step under the collective recorder
    # (scripts/tp_collective_budget.py)
    from gill_tpu_torch.scripts import tp_collective_budget as tcb

    res["collectives"] = tcb.measure(full["lm"], core.opt_cfg, mesh,
                                     torch.device("cpu"), batch=3,
                                     max_seq=32, reps=1)
    return res


# ---------------------------------------------------------------------------
# retrieval
# ---------------------------------------------------------------------------

def sharded_topk(mat, scale: float, queries, k: int, seen):
    from gill_tpu_torch.retrieval import RetrievalIndex

    mesh = create_mesh(dist.get_world_size(), 1)
    idx = RetrievalIndex([str(i) for i in range(len(mat))], mat, scale,
                         device="cpu", mesh=mesh)
    vals, ids = idx.topk_batch(queries, k, seen)
    return {"vals": vals, "ids": ids, "rows": idx.rows,
            "scores_for": idx.scores_for(queries[0], [0, len(mat) - 1])}


# ---------------------------------------------------------------------------
# training and validation
# ---------------------------------------------------------------------------

def _metrics_np(m):
    out = {k: np.asarray(v, np.float32) for k, v in m.items() if k != "_viz"}
    return out


def _packed_loss_and_grads(core, tc, frozen, adapters, batch):
    """The concat-packed step's loss, metrics and adapter gradients
    (summed over "data") on this rank's rows, before any update."""
    from gill_tpu_torch.parallel.collectives import sum_over_data
    from gill_tpu_torch.train import trainer as T

    params = {**frozen, "adapters": adapters}
    with torch.enable_grad():
        loss, m = T.compute_losses(core, params, batch, tc, True)
        leaves = tree_leaves(adapters)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = iter(sum_over_data([torch.zeros_like(p) if g is None else g
                                for p, g in zip(leaves, grads)], core.mesh))
    return _metrics_np(m), _np(tree_map(lambda _: next(grads), adapters))


def train_steps(core_kw, tc_kw, seed: int, batch, concat_seq, dp: int,
                tp: int, odd_batch=None):
    """The train step at mesh (dp, tp), each rank on its data rows of the
    global batch: every step's metrics and adapters, this rank's own
    caption CE mean before the first step (what a mean of per-rank means
    would average), and whether the adapters agree bit for bit across
    every rank. Rank 0 alone returns the adapters (the others hold the
    same bits). With `odd_batch` (a global batch whose rows split into
    an odd count a rank) also its concat-packed metrics and adapter
    gradients (`odd`)."""
    from gill_tpu_torch.models import opt as opt_mod
    from gill_tpu_torch.train import trainer as T

    params = make_params(core_kw, seed)
    mesh = create_mesh(dp, tp)
    core = make_core(core_kw, mesh)
    tc = tcfg.TrainConfig(**tc_kw)
    full = {"lm": from_jax.opt_from_jax(params["lm"]),
            "vision": from_jax.clip_vision_from_jax(params["vision"])}
    frozen = P.shard_params(full, mesh) if tp > 1 else full
    state = T.init_state(tc, from_jax.adapters_from_jax(params["adapters"]))
    local = T.put_batch(P.split_batch(batch, mesh), "cpu")
    with torch.no_grad():
        cap = make_core(core_kw).forward(
            {**full, "adapters": state.adapters}, local["pixels"],
            local["ret_tokens"], local["ret_len"], mode="captioning")
        own_mean = float(opt_mod.loss_fn(cap["logits"], cap["full_labels"]))
    odd = None
    if odd_batch is not None:
        odd = _packed_loss_and_grads(
            core, tc, frozen, T.init_state(tc, state.adapters).adapters,
            T.put_batch(P.split_batch(odd_batch, mesh), "cpu"))
    step = T.make_train_step(core, tc)
    runs = []
    for concat in concat_seq:
        state, m = step(state, frozen, local, concat=concat)
        runs.append((_metrics_np(m), _np(state.adapters)
                     if mesh.rank == 0 else None))
    flat = torch.cat([x.detach().reshape(-1)
                      for x in tree_leaves(state.adapters)])
    return {"runs": runs, "own_cap_ce": own_mean, "odd": odd,
            "adapters_equal_across_ranks": C.all_equal(flat)}


def validate_dp(core_kw, tc_kw, seed: int, batches, prefix):
    """`validate` at dp = world, each rank on its contiguous half of every
    batch; the scalars it writes."""
    from gill_tpu_torch.tokenizer import GPT2BPETokenizer
    from gill_tpu_torch.train import validate as V

    class Writer:
        def __init__(self):
            self.scalars = {}

        def add_scalar(self, k, v, step):
            self.scalars[k] = (float(v), step)

        def add_image(self, *a, **k):
            pass

    params = make_params(core_kw, seed)
    mesh = create_mesh(dist.get_world_size(), 1)
    core = make_core(core_kw, mesh)
    frozen = {"lm": from_jax.opt_from_jax(params["lm"]),
              "vision": from_jax.clip_vision_from_jax(params["vision"])}
    w = Writer()
    local = [P.split_batch(b, mesh) for b in batches]
    with redirect_stdout(io.StringIO()):
        top1 = V.validate(core, tcfg.TrainConfig(**tc_kw),
                          from_jax.adapters_from_jax(params["adapters"]),
                          frozen, local, GPT2BPETokenizer.tiny(), epoch=2,
                          writer=w, prefix_ids=torch.from_numpy(prefix).long(),
                          device="cpu")
    return {"top1": top1, "scalars": w.scalars}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def cli_resume(argv_full, argv_first, argv_resume_head):
    """An uninterrupted two-epoch CLI run, a one-epoch run and its resume
    from the collective checkpoint, each final checkpoint read back with
    `load_checkpoint_orbax`: their metas, whether the resumed run's leaves
    equal the uninterrupted run's bit for bit (and the first run's do
    not), a digest of the final tree and the log directories."""
    import hashlib

    from gill_tpu_torch import main as tmain
    from gill_tpu_torch.utils import ckpt

    with redirect_stdout(io.StringIO()):
        dirs = [tmain.main(argv_full), tmain.main(argv_first)]
        first, first_meta = ckpt.load_checkpoint_orbax(dirs[1])
        dirs.append(tmain.main(argv_resume_head + ["--resume", dirs[1]]))
    full, full_meta = ckpt.load_checkpoint_orbax(dirs[0])
    resumed, resumed_meta = ckpt.load_checkpoint_orbax(dirs[2])
    leaves = [np.asarray(x) for x in tree_leaves(full)]
    digest = hashlib.sha1(b"".join(x.tobytes() for x in leaves)).hexdigest()
    return {"dirs": dirs, "leaves": len(leaves), "digest": digest,
            "metas": [full_meta, first_meta, resumed_meta],
            "resumed_equal": all(np.array_equal(a, np.asarray(b)) for a, b
                                 in zip(leaves, tree_leaves(resumed))),
            "first_differs": any(not np.array_equal(a, np.asarray(b))
                                 for a, b in zip(leaves,
                                                 tree_leaves(first)))}


# ---------------------------------------------------------------------------
# tensor-parallel online serving
# ---------------------------------------------------------------------------

def _gated(eng, holds: dict):
    """Parks the scheduler inside `_run_chunk` call n (1-based) until
    holds[n][1] is set; holds[n][0] is set once it is parked there."""
    orig = eng._run_chunk
    calls = [0]

    def gated():
        calls[0] += 1
        if calls[0] in holds:
            parked, go = holds[calls[0]]
            parked.set()
            if not go.wait(60):
                raise RuntimeError("the chunk was not released")
        return orig()

    eng._run_chunk = gated


def _park(holds, n):
    import threading

    holds[n] = (threading.Event(), threading.Event())
    return holds[n]


def _lm_online(full, opt_kw, engine_kw, mesh, collect=None):
    """OnlineEngine over DecodeEngine(mesh=); `collect` replaces the
    engine's `_collect` before its scheduler starts."""
    from gill_tpu_torch.serve.engine import DecodeEngine
    from gill_tpu_torch.serve.online import OnlineEngine

    eng = DecodeEngine(full["lm"], tcfg.OPTConfig(**opt_kw), mesh=mesh,
                       device="cpu", kv_dtype=torch.float32, **engine_kw)
    if collect is not None:
        eng._collect = collect
    return OnlineEngine(eng)


def _follow(online) -> dict:
    """A follower's part: its public calls refused, then it blocks until
    the leader closes; its engine's counters (rank 0's when the slot
    states agree)."""
    try:
        online.submit([5, 6], 2)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    online.wait_closed()
    return {"refused": refused, "stats": dict(online.eng.stats)}


def _staggered(online, reqs, gap: float):
    import time

    hs = []
    for p, n in reqs:
        hs.append(online.submit(p, n))
        time.sleep(gap)
    return [h.result(timeout=120) for h in hs]


def online_tp(core_kw, seed: int, opt_kw, engine_kw, gill_engine_kw,
              staggered, cancel, prefix, gill, idle_s: float,
              pg_timeout: float):
    """OnlineEngine and GillOnlineEngine over engines with a mesh, one
    engine after another on every rank: rank 0 serves each case's requests
    (staggered submits, a queued and an in-flight cancel, prefix tickets,
    an idle spell longer than the group's timeout, GILL requests with an
    embedding prefix) and returns what its handles gave; the other ranks
    follow (each returns its refused submit and its engines' counters).
    The world's timeout is cut to `pg_timeout` once the group is up, so
    the groups made after it (the mesh's, the online engines') wait that
    long. Last, a follower's chunk collect raises while rank 0's request
    is in flight: the time rank 0's handle took to fail, and every rank's
    scheduler error."""
    import datetime
    import time

    import torch.distributed.distributed_c10d as c10d

    from gill_tpu_torch.serve.gill_engine import GillDecodeEngine
    from gill_tpu_torch.serve.online import GillOnlineEngine

    c10d._set_pg_timeout(datetime.timedelta(seconds=pg_timeout))
    world = dist.get_world_size()
    lead = dist.get_rank() == 0
    full = from_jax.gill_params_from_jax(make_params(core_kw, seed))
    out = {}

    # the LM engine at mesh (1, world): arrivals, cancels, prefixes, idle
    mesh = create_mesh(1, world)
    online = _lm_online(full, opt_kw, engine_kw, mesh)
    out["heartbeat_s"] = online._sync.heartbeat
    if lead:
        out["staggered"] = _staggered(online, staggered, 0.05)
        holds = {}
        p1, g1 = _park(holds, 1)
        p2, g2 = _park(holds, 2)
        _gated(online.eng, holds)
        warm = online.submit(*cancel["warm"])
        assert p1.wait(60)
        # while chunk 1 (the warm request's) is held: the next wave fills
        # the slots and one more request queues behind it
        hs = [online.submit(p, n) for p, n in cancel["reqs"]]
        g1.set()
        assert p2.wait(60)
        hs[cancel["in_flight"]].cancel()
        hs[cancel["queued"]].cancel()
        g2.set()
        out["cancel"] = {"warm": warm.result(timeout=120),
                         "reqs": [h.result(timeout=120) for h in hs],
                         "flags": [h.cancelled for h in hs]}
        pid0 = online.register_prefix(prefix["prefix"])
        pid1 = online.extend_prefix(pid0, prefix["extension"])
        hs = [online.submit(p, n, prefix_id=[pid0, pid1][k])
              for p, n, k in prefix["reqs"]]
        res = [h.result(timeout=120) for h in hs]
        online.drop_prefix(pid0)
        try:
            online.submit(prefix["reqs"][0][0], 2, prefix_id=pid0)
            dropped = None
        except ValueError as e:
            dropped = str(e)
        out["prefix"] = {"pids": [pid0, pid1], "tokens": res,
                         "dropped": dropped}
        time.sleep(idle_s)
        p, n = staggered[0]
        out["after_idle"] = online.submit(p, n).result(timeout=120)
        online.close()
        out["stats"] = dict(online.eng.stats)
    else:
        out["follower"] = _follow(online)

    # the GILL engine at mesh (1, world), an embedding prefix
    geng = GillDecodeEngine(make_core(core_kw, mesh), full, mesh=mesh,
                            device="cpu", kv_dtype=torch.float32,
                            **gill_engine_kw)
    gonline = GillOnlineEngine(geng)
    if lead:
        pid = gonline.register_prefix(gill["prefix"])
        hs = [gonline.submit(c["embs"], c["num_words"],
                             img_scale=c["img_scale"],
                             prefix_id=pid if c["prefixed"] else None)
              for c in gill["cases"]]
        out["gill"] = [{"tokens": h.result(timeout=120),
                        "img_runs": h.img_runs} for h in hs]
        gonline.close()
        out["gill_stats"] = dict(geng.stats)
    else:
        out["gill_follower"] = _follow(gonline)

    # mesh (world, 1): every rank a replica, ticks over the world
    online = _lm_online(full, opt_kw, engine_kw, create_mesh(world, 1))
    if lead:
        out["replicas"] = _staggered(online, staggered, 0.0)
        online.close()
        out["replica_stats"] = dict(online.eng.stats)
    else:
        out["replica_follower"] = _follow(online)

    # a follower's collect raises at its first chunk
    def boom(toks):
        raise RuntimeError("a fault injected on a follower")

    online = _lm_online(full, opt_kw, engine_kw, mesh,
                        None if lead else boom)
    if lead:
        t0 = time.perf_counter()
        h = online.submit(*cancel["reqs"][0])   # longer than one chunk
        try:
            h.result(timeout=4 * pg_timeout)
            out["fault"] = {"error": None}
        except RuntimeError as e:
            out["fault"] = {"error": str(e)}
        out["fault"]["s"] = time.perf_counter() - t0
        try:
            online.wait_closed(4 * pg_timeout)
        except RuntimeError:
            pass                           # the crash, read below
        out["fault"]["crash"] = online.crash
    else:
        try:
            online.wait_closed(4 * pg_timeout)
            out["fault"] = {"crash": None}
        except RuntimeError as e:
            out["fault"] = {"crash": str(e)}
    out["fault"]["thread_alive"] = online._thread.is_alive()
    return out
