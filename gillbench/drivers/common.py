"""What the drivers share: the run's settings, the kernel build, the window
clock of a closed loop, memory, and the traced slice's reduction."""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import List, Optional

from gillbench.harness import Cell
from gillbench.trace import Slice, reduce_events


@dataclasses.dataclass
class RunSpec:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object                 # torch.device
    t_process: float               # perf_counter at process start
    control: bool = False          # the lower-precision control
    fault: Optional[str] = None    # tests only: a fault planted in the path
    log: object = None             # callable(str): progress on stderr


def build_kernels(libs, device) -> float:
    """Builds (or finds in gill_tpu_torch/csrc/build/) the CUDA libraries
    the cell loads; the seconds nvcc took, 0 when all were built."""
    if device.type != "cuda":
        return 0.0
    from gill_tpu_torch.ops import _build

    t = time.perf_counter()
    took = _build.build_all(names=tuple(libs))
    return time.perf_counter() - t if took else 0.0


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The process's peak of allocated device memory (nothing is allocated
    before the cell's set-up, and the reference runs after this is read)."""
    import torch

    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def device_kind(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


class Pool:
    """A closed loop's shared request pool, cycled in order."""

    def __init__(self, items: list):
        self.items = items
        self._it = itertools.count()
        self._lock = threading.Lock()

    def next(self):
        with self._lock:
            i = next(self._it)
        return i, self.items[i % len(self.items)]


def layer_context(slc: Slice, spans: List[dict], owners=(),
                  **extra) -> dict:
    """What per-layer readers read: the reduced trace (`owners` as
    `trace.reduce_events` takes them), the slice's spans, its length, and
    what the cell's driver module adds (counters, FLOPs)."""
    red = reduce_events(slc.raw, spans, owners)
    ctx = {"red": red, "spans": [s for s in spans if s["t1"] is not None],
           "slice_s": slc.wall_s, "busy_s": red["busy_s"]}
    ctx.update(extra)
    return ctx


def stats_delta(a: dict, b: dict) -> dict:
    return {k: b.get(k, 0) - a.get(k, 0) for k in b}
