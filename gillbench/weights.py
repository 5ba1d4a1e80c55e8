"""Weights made by the benchmark from --seed, on the device, in a few large
calls.

`seeded_trees([(build, dtype), ...], generator, device)` runs each
`build(init)` twice: once
on the meta device to learn every random leaf's shape, then for real. All
uniform leaves of one dtype are views of one buffer filled by a single
`uniform_(-1, 1)` call and scaled in place to their bound; normal leaves share
a second buffer filled by one `normal_` call. Constant leaves (LayerNorm
scales, zero biases) are allocated as they are. `build` is the port's own
init function: it decides the tree's layout (the parameter format the port
reads) and each leaf's distribution; the values come from the benchmark's
generator. The reference reads the same tensors.

Each leaf starts on a 512-byte boundary of its buffer, as a leaf of its own
allocation would: cuDNN, cuBLAS and the port's kernels take slower paths,
or copy, where a tensor's address is not 16-byte aligned.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch


ALIGN_BYTES = 512


def _span(n: int, dtype: torch.dtype) -> int:
    """Elements a leaf of n takes in its buffer, rounded up so that the next
    leaf starts on an ALIGN_BYTES boundary."""
    step = ALIGN_BYTES // torch.empty((), dtype=dtype).element_size()
    return -(-n // step) * step


class _Plan:
    def __init__(self):
        self.sizes: Dict[Tuple[str, torch.dtype], int] = {}

    def take(self, kind, dtype, n):
        key = (kind, dtype)
        self.sizes[key] = self.sizes.get(key, 0) + _span(n, dtype)


class SeededInit:
    """Duck-typed stand-in for the port's `nn.core.Init`: the same methods,
    leaves carved out of per-dtype buffers. Pass 1 (`plan`) returns meta
    tensors and counts; pass 2 returns views of the filled buffers."""

    def __init__(self, device, dtype, plan: _Plan, buffers=None,
                 offsets=None):
        self.device = torch.device(device)
        self.dtype = dtype
        self._plan = plan
        self._bufs = buffers
        self._offs: Dict[Tuple[str, torch.dtype], int] = \
            {} if offsets is None else offsets

    def _leaf(self, kind, shape, dtype):
        dtype = dtype or self.dtype
        n = math.prod(shape)
        if self._bufs is None:
            self._plan.take(kind, dtype, n)
            return torch.empty(tuple(shape), device="meta", dtype=dtype)
        key = (kind, dtype)
        off = self._offs.get(key, 0)
        self._offs[key] = off + _span(n, dtype)
        return self._bufs[key][off:off + n].view(tuple(shape))

    def uniform(self, shape, bound: float, dtype=None):
        return self._leaf("u", shape, dtype).mul_(bound) \
            if self._bufs is not None else self._leaf("u", shape, dtype)

    def normal(self, shape, std: float = 1.0, dtype=None):
        return self._leaf("n", shape, dtype).mul_(std) \
            if self._bufs is not None else self._leaf("n", shape, dtype)

    def full(self, shape, value: float):
        dev = "meta" if self._bufs is None else self.device
        return torch.full(tuple(shape), value, device=dev, dtype=self.dtype)

    # the port's parameter bundles (nn.core.Init), over the methods above
    def linear(self, in_dim, out_dim, bias=True, lead=()):
        bound = 1.0 / math.sqrt(in_dim)
        p = {"w": self.uniform((*lead, in_dim, out_dim), bound)}
        if bias:
            p["b"] = self.uniform((*lead, out_dim), bound)
        return p

    def layer_norm(self, dim, lead=()):
        return {"scale": self.full((*lead, dim), 1.0),
                "bias": self.full((*lead, dim), 0.0)}

    group_norm = layer_norm

    def embedding(self, num, dim, std=0.02):
        return {"weight": self.normal((num, dim), std)}

    def conv2d(self, in_ch, out_ch, kernel):
        bound = 1.0 / math.sqrt(in_ch * kernel * kernel)
        w = self.uniform((out_ch, kernel, kernel, in_ch), bound)
        return {"w": w.permute(0, 3, 1, 2),
                "b": self.uniform((out_ch,), bound)}

    def mha(self, dim, lead=()):
        return {k: self.linear(dim, dim, lead=lead) for k in "qkvo"}


def seeded_trees(builds: List[Tuple[Callable, torch.dtype]],
                 generator: torch.Generator, device) -> list:
    """Runs each `build(init)` (with its dtype) over shared buffers: one
    uniform and one normal fill a dtype for all of them. Returns the built
    trees."""
    plan = _Plan()
    for b, dtype in builds:
        b(SeededInit("meta", dtype, plan))
    bufs = {}
    for (kind, dt), n in sorted(plan.sizes.items(), key=str):
        buf = torch.empty((n,), device=device, dtype=dt)
        if kind == "u":
            buf.uniform_(-1.0, 1.0, generator=generator)
        else:
            buf.normal_(0.0, 1.0, generator=generator)
        bufs[(kind, dt)] = buf
    offs: Dict[Tuple[str, torch.dtype], int] = {}
    return [b(SeededInit(device, dtype, plan, bufs, offs))
            for b, dtype in builds]


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded from a --seed of any size."""
    return torch.Generator(device=device).manual_seed(
        int(seed) % (2 ** 63 - 1))
