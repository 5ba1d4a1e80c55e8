"""The collectives of the mesh, explicit where gill_tpu's GSPMD inserts
them.

Megatron's pair brackets the model-parallel region of a decoder layer
(a column-parallel product, local heads, a row-parallel product):

  * `copy_to_model`: identity forward, all-reduce of the gradient over
    "model" backward (each rank's column shard contributes a partial
    input gradient);
  * `reduce_from_model`: all-reduce over "model" forward, identity
    backward (the summed output's gradient is every rank's partial's).

torch.distributed.nn.functional.all_reduce is not used for the reduce:
its backward all-reduces the gradient again, which multiplies it by tp.

`gather_data` concatenates every data rank's rows forward and hands each
rank its own slice of the gradient backward: every rank computes the
whole loss of the gathered rows, so the gradient of its rows is already
whole, and the sum over "data" of the adapters' gradients (the trainer's
`sum_over_data`) adds each rank's own contribution once. Ranks may hold
different row counts (a concat-packed step, `exchange_first_rows`).

Without a group of more than one rank (no mesh, the single-device mesh,
or an axis of size 1) every function returns its input. Only `all_reduce`, `broadcast` and the list form of
`all_gather` are used: gloo runs those on CUDA tensors too.

`broadcast_tick` and `all_status` are the online engines' control channel
(serve/online.py): rank 0's scheduling decisions for one chunk boundary
to every rank, and every rank's health after it.

`record_collectives()` counts every collective these functions issue
while it is open (kind, dtype, bytes a rank hands in, group size), for
scripts/tp_collective_budget.py. It changes nothing; while none is open
a collective pays one test of a module global for it.
"""

from __future__ import annotations

import contextlib
import json
from collections import Counter
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist


class CollectiveRecorder:
    """The collectives issued while `record_collectives()` was open:
    `counts` maps (kind, dtype, bytes, group size) to a count, bytes being
    what this rank hands in (for an all-gather, its own part)."""

    def __init__(self):
        self.counts: Counter = Counter()

    def add(self, kind: str, t: torch.Tensor, group):
        self.counts[(kind, str(t.dtype).split(".")[-1],
                     t.numel() * t.element_size(),
                     dist.get_world_size(group))] += 1

    def total(self, kind: Optional[str] = None) -> int:
        return sum(n for k, n in self.counts.items()
                   if kind is None or k[0] == kind)

    def rows(self) -> List[dict]:
        """One row a (kind, dtype, bytes, group size), largest count
        first."""
        return [{"kind": k, "dtype": d, "bytes": b, "group": g, "count": n}
                for (k, d, b, g), n in sorted(
                    self.counts.items(), key=lambda kv: (-kv[1], kv[0]))]


_RECORDER: Optional[CollectiveRecorder] = None


def _record(kind: str, t: torch.Tensor, group=None):
    if _RECORDER is not None:
        _RECORDER.add(kind, t, group)


@contextlib.contextmanager
def record_collectives():
    """Counts the collectives of this module while open; yields the
    `CollectiveRecorder`."""
    global _RECORDER
    prev, _RECORDER = _RECORDER, CollectiveRecorder()
    try:
        yield _RECORDER
    finally:
        _RECORDER = prev


def model_group(mesh):
    """The "model" group, None where it has one rank (no collective)."""
    return None if mesh is None or mesh.tp == 1 else mesh.model


def data_group(mesh):
    """The "data" group, None where it has one rank (no collective)."""
    return None if mesh is None or mesh.dp == 1 else mesh.data


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _record("all_reduce", g, ctx.group)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        _record("all_reduce", y, group)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_gather_rows(x, group, counts=None):
    """Every rank's rows, rank-major; `counts` (one per rank) where ranks
    hold different counts: each pads to the largest, the pads dropped."""
    x = x.contiguous()
    big = x.shape[0] if counts is None else max(counts)
    if x.shape[0] < big:
        x = torch.cat([x, x.new_zeros((big - x.shape[0], *x.shape[1:]))])
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    _record("all_gather", x, group)
    dist.all_gather(parts, x, group=group)
    if counts is None:
        return torch.cat(parts)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, counts):
        r = dist.get_rank(group)
        ctx.lo = r * x.shape[0] if counts is None else sum(counts[:r])
        ctx.n = x.shape[0]
        return _all_gather_rows(x, group, counts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.lo:ctx.lo + ctx.n], None, None


def _grad_path(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_model(x, mesh):
    """Enters the model-parallel region: x unchanged; under grad, its
    gradient is all-reduced over "model"."""
    group = model_group(mesh)
    if group is None or not _grad_path(x):
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, mesh):
    """Leaves the model-parallel region: the sum of every model rank's
    partial x. Without grad, x (a fresh product) is reduced in place."""
    group = model_group(mesh)
    if group is None:
        return x
    if _grad_path(x):
        return _ReduceFromModel.apply(x, group)
    x = x.contiguous()
    _record("all_reduce", x, group)
    dist.all_reduce(x, group=group)
    return x


def gather_data(x, mesh, counts: Optional[List[int]] = None):
    """(n, ...) rows of every data rank, rank-major, as (dp n, ...); the
    backward returns this rank's slice of the gradient. Every data rank
    gives the same n, or `counts` lists each data rank's n."""
    group = data_group(mesh)
    if group is None:
        return x
    if counts is not None and counts[mesh.dp_rank] != x.shape[0]:
        raise ValueError(f"{x.shape[0]} rows, counts {counts}")
    if _grad_path(x):
        return _GatherData.apply(x, group, counts)
    return _all_gather_rows(x, group, counts)


def exchange_first_rows(x, mesh, send: bool, receive: bool):
    """Every data rank's first row all-gathered over "data" (one
    collective, every rank takes part); returns x without its first row
    when `send` (it belongs to the rank before) and with the next data
    rank's first row appended when `receive`. Without grad only (the
    batch's inputs)."""
    group = data_group(mesh)
    if group is None:
        return x
    first = x[:1].contiguous()
    parts = [torch.empty_like(first) for _ in range(mesh.dp)]
    _record("all_gather", first, group)
    dist.all_gather(parts, first, group=group)
    out = x[1:] if send else x
    if receive:
        out = torch.cat([out, parts[mesh.dp_rank + 1]])
    return out


@torch.no_grad()
def global_count(n: torch.Tensor, mesh) -> torch.Tensor:
    """A count (or any no-grad sum) summed over "data"."""
    group = data_group(mesh)
    if group is None:
        return n
    n = n.clone()
    _record("all_reduce", n, group)
    dist.all_reduce(n, group=group)
    return n


@torch.no_grad()
def sum_over_data(tensors: List[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Each tensor summed over "data", through one flat buffer per dtype
    (one all-reduce for the adapters' gradients)."""
    group = data_group(mesh)
    if group is None or not tensors:
        return list(tensors)
    out = list(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        _record("all_reduce", flat, group)
        dist.all_reduce(flat, group=group)
        lo = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[lo:lo + n].view_as(tensors[i])
            lo += n
    return out


def gather_rows(x, mesh, group=None) -> np.ndarray:
    """This rank's rows in, every data rank's rows out, rank-major, as
    numpy (gill_tpu's `host_local_rows` + `process_allgather`). Ranks may
    hold different row counts (a last validation batch). `group`
    overrides the mesh's data group."""
    group = data_group(mesh) if group is None else group
    arr = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    if group is None:
        return arr
    n = dist.get_world_size(group)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    mine = torch.tensor([t.shape[0]], dtype=torch.int64)
    _record("all_gather", mine, group)
    dist.all_gather(sizes, mine, group=group)
    sizes = [int(s) for s in sizes]
    big = max(sizes)
    if t.shape[0] < big:
        t = torch.cat([t, t.new_zeros((big - t.shape[0], *t.shape[1:]))])
    parts = [torch.empty_like(t) for _ in range(n)]
    _record("all_gather", t, group)
    dist.all_gather(parts, t, group=group)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)]).numpy()


def broadcast_str(s: Optional[str], src: int = 0, limit: int = 4096) -> str:
    """A string from global rank `src` (null-padded utf-8, as main.py
    broadcasts the log directory)."""
    if not dist.is_initialized():
        return s
    buf = torch.zeros(limit, dtype=torch.uint8)
    if dist.get_rank() == src:
        enc = s.encode()
        if len(enc) > limit:
            raise ValueError(f"{len(enc)} bytes exceed {limit}")
        buf[:len(enc)] = torch.frombuffer(bytearray(enc), dtype=torch.uint8)
    _record("broadcast", buf)
    dist.broadcast(buf, src=src)
    return bytes(buf[buf != 0].tolist()).decode()


def all_equal(t: torch.Tensor, group=None) -> bool:
    """Whether every rank of `group` holds `t` bit for bit (a check of
    the replicated state)."""
    if not dist.is_initialized():
        return True
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _record("all_gather", t, group)
    dist.all_gather(parts, t.contiguous(), group=group)
    return all(torch.equal(p, parts[0]) for p in parts)


def broadcast_tick(tick: Optional[dict], tensors: List[torch.Tensor], group,
                   device, src: int = 0):
    """Rank `src`'s tick to every rank of `group`: (tick, tensors). Its
    small fields (a dict of numbers, strings, lists and None) travel as one
    JSON object in a uint8 host tensor, its length first; each tensor of
    `tensors` (an embedding payload) travels as a tensor of its own on
    `device`, allocated on the receivers from the shapes and dtypes the
    object lists. Two collectives, plus one a tensor. The other ranks pass
    None and [] and get rank `src`'s."""
    rank = dist.get_rank()
    if rank == src:
        head = json.dumps({"tick": tick, "tensors": [
            [list(t.shape), str(t.dtype).split(".")[-1]] for t in tensors]})
        buf = torch.frombuffer(bytearray(head.encode()), dtype=torch.uint8)
        n = torch.tensor([buf.numel()], dtype=torch.int64)
    else:
        n = torch.zeros(1, dtype=torch.int64)
    _record("broadcast", n, group)
    dist.broadcast(n, src=src, group=group)
    if rank != src:
        buf = torch.empty(int(n), dtype=torch.uint8)
    _record("broadcast", buf, group)
    dist.broadcast(buf, src=src, group=group)
    head = json.loads(bytes(buf.numpy()).decode())
    out = []
    for i, (shape, dtype) in enumerate(head["tensors"]):
        t = (tensors[i].to(device).contiguous() if rank == src
             else torch.empty(shape, dtype=getattr(torch, dtype),
                              device=device))
        _record("broadcast", t, group)
        dist.broadcast(t, src=src, group=group)
        out.append(t)
    return head["tick"], out


def all_status(msg: str, group, limit: int = 512) -> List[str]:
    """Every rank's status string over `group`, in rank order (utf-8,
    null-padded to `limit` bytes, the longer cut): "" where a rank is
    well, its error where it failed. One all-gather of host tensors."""
    buf = torch.zeros(limit, dtype=torch.uint8)
    enc = msg.encode()[:limit]
    if enc:
        buf[:len(enc)] = torch.frombuffer(bytearray(enc), dtype=torch.uint8)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    _record("all_gather", buf, group)
    dist.all_gather(parts, buf, group=group)
    return [bytes(p[p != 0].tolist()).decode(errors="replace")
            for p in parts]
