"""The process mesh (counterpart of gill_tpu/parallel/mesh.py).

gill_tpu reshapes its devices into a ("data", "model") mesh. Here each
rank is a process: `init_distributed` starts the default process group
from torch.distributed.run's environment, and `create_mesh` lays the
ranks out row-major as (dp, tp), as `np.reshape(devices, (dp, tp))` lays
gill_tpu's devices, and makes one "data" group (the ranks of one model
coordinate) and one "model" group (the ranks of one data coordinate) for
this rank. Gradients of replicated parameters reduce over "data"; the
frozen OPT's matrices shard over "model" (partition.py).

Backend: NCCL when every rank of the host has a card of its own (with
gloo for CPU tensors: "cpu:gloo,cuda:nccl"), gloo when ranks share a card
(NCCL refuses two ranks on one device in a communicator) or run on the
CPU. On CUDA tensors gloo stages
`all_reduce`, `broadcast` and the list form of `all_gather` through host
memory, and the collectives of this package use only those.

A world of 1 with no launcher environment is the single-device case: no
process group, a mesh of shape (1, 1) with no groups, and no collective.

Every group made here waits as long as the world's group before a
collective fails (`group_timeout`): torch gives a new group its backend's
default (30 minutes on gloo) instead, so a rank that stopped would hang
the reduces of a tensor-parallel forward for that long.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

ENV_KEYS = ("RANK", "WORLD_SIZE")


@dataclasses.dataclass
class Mesh:
    """A rank's view of the (dp, tp) mesh: `shape` {"data": dp, "model":
    tp}, this rank's coordinates (data, model) and its two groups (None in
    the single-device case)."""
    shape: dict
    rank: int
    coords: tuple
    data: Optional[object] = None
    model: Optional[object] = None

    @property
    def dp(self) -> int:
        return self.shape["data"]

    @property
    def tp(self) -> int:
        return self.shape["model"]

    @property
    def dp_rank(self) -> int:
        return self.coords[0]

    @property
    def tp_rank(self) -> int:
        return self.coords[1]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.dp}, model={self.tp}, rank={self.rank}, "
                f"coords={self.coords})")


def launched() -> bool:
    """Whether a launcher (torch.distributed.run, `launch.run_ranks`) set
    this process's rank environment."""
    return all(k in os.environ for k in ENV_KEYS)


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when every local rank has a card of its own, else gloo."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_distributed(device="cuda", *, timeout: Optional[float] = None,
                     init_method: Optional[str] = None) -> torch.device:
    """Starts the default process group from the launcher's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE; MASTER_ADDR/PORT for
    the default env:// rendezvous unless `init_method` names another, as
    `launch.run_ranks`'s file store) and returns this rank's device:
    cuda:(LOCAL_RANK % device_count) unless the caller asks for the CPU.
    Prints the backend chosen. With no launcher environment it starts
    nothing (the single-device case). `timeout`: seconds a collective may
    wait before it fails, so a rank that diverges fails the run instead of
    hanging it."""
    device = torch.device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass the CPU "
                               "device to run the ranks on the CPU")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if dist.is_initialized() or not launched():
        return device
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    backend = choose_backend(device, local_world)
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group("cpu:gloo,cuda:nccl" if backend == "nccl"
                            else backend, init_method=init_method or "env://",
                            rank=rank, world_size=world, **kw)
    print(f"torch.distributed: rank {rank} of {world}, backend {backend}, "
          f"device {device} ({local_world} rank(s) on this host, "
          f"{torch.cuda.device_count() if device.type == 'cuda' else 0} "
          f"card(s))", flush=True)
    return device


def group_timeout(group=None) -> float:
    """Seconds a collective of `group` (default: the world's) waits before
    it fails, as the group was made with (`init_distributed(timeout=)`).
    Every group here has a gloo backend for CPU tensors, which holds it."""
    group = dist.group.WORLD if group is None else group
    backend = group._get_backend(torch.device("cpu"))
    return backend.options._timeout.total_seconds()


def new_group(ranks) -> object:
    """`dist.new_group(ranks)` with the world's timeout (`group_timeout`).
    Every rank of the world calls it, in the same order."""
    return dist.new_group(ranks, timeout=datetime.timedelta(
        seconds=group_timeout()))


def create_mesh(dp_size: int = -1, tp_size: int = 1) -> Mesh:
    """The (dp, tp) mesh over the initialized process group (or the
    single-device mesh when there is none). dp_size -1 takes the world
    over tp_size. Rank r sits at (r // tp, r % tp). Every rank must call
    this, in the same order as its other collectives: each group is made
    by all ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dp_size == -1:
        if world % tp_size:
            raise ValueError(f"world size {world} is not a multiple of "
                             f"tp_size {tp_size}")
        dp_size = world // tp_size
    if dp_size * tp_size != world:
        raise ValueError(f"dp_size {dp_size} x tp_size {tp_size} != world "
                         f"size {world}")
    coords = divmod(rank, tp_size)
    mesh = Mesh(shape={"data": dp_size, "model": tp_size}, rank=rank,
                coords=coords)
    if not dist.is_initialized():
        return mesh
    for t in range(tp_size):
        g = new_group([d * tp_size + t for d in range(dp_size)])
        if t == coords[1]:
            mesh.data = g
    for d in range(dp_size):
        g = new_group([d * tp_size + t for t in range(tp_size)])
        if d == coords[0]:
            mesh.model = g
    return mesh
