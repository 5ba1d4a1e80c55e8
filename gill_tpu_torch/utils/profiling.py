"""Profiling and step timing (counterpart of gill_tpu/utils/profiling.py,
whose `trace` records a jax.profiler trace).

`trace(log_dir)` records the enclosed block with torch.profiler, the CPU
and, where a card is present, its CUDA activity, and writes a Chrome trace
(`trace.json`, for chrome://tracing or Perfetto) into `log_dir`; it
returns the profiler, so a caller can also read `key_averages()` or the
device events. `StepTimer` is per-step host timing with an exponential
moving average, for examples/s style metrics.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str, cuda=None):
    """Captures a torch.profiler trace of the enclosed block:

        with profiling.trace(log_dir) as prof:
            step(...)

    `cuda`: record the CUDA activity too (default: whether a card is
    available). The block's queued device work is waited for before the
    trace is written."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Per-step host timing with an EMA, for examples/sec style metrics."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema = None
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.ema = dt if self.ema is None else \
            (1 - self.alpha) * self.ema + self.alpha * dt
        return dt
