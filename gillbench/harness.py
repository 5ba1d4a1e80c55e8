"""What every run shares: BENCHMARK.json and the files it names, the guard
against JAX, the caches inside the checkout, and the result line.

Nothing here imports torch at import time, so `--help` and the refusal
without a card stay cheap.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
BENCHMARK_JSON = os.path.join(ROOT, "BENCHMARK.json")

# top-level module names that no run may hold: the JAX package this port was
# made from, and JAX itself. Compared whole, so gill_tpu_torch passes.
FORBIDDEN = ("jax", "jaxlib", "flax", "gill_tpu")

# every cache a run writes stays inside the checkout, at a fixed path, so
# that only a checkout's first run builds
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a bad name, JAX loaded)."""


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose whole top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def set_cache_env() -> None:
    """Points the build and kernel caches a run may fill at fixed
    directories inside the checkout. The port builds its CUDA libraries
    into its own gill_tpu_torch/csrc/build/, inside the checkout too."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_benchmark(path: str = BENCHMARK_JSON) -> dict:
    if not os.path.exists(path):
        raise BenchError(f"no BENCHMARK.json at {path}")
    with open(path) as f:
        return json.load(f)


def _by_name(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise BenchError(f"unknown {what} {name!r}")


def bench_file(rel: str) -> str:
    """A path of BENCHMARK.json, resolved against the checkout's root."""
    path = os.path.normpath(os.path.join(ROOT, rel))
    if not path.startswith(BENCH_DIR + os.sep):
        raise BenchError(f"{rel} lies outside gillbench/")
    return path


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(name: str):
    """The reader module of one per-layer metric, metrics/<name>.py."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise BenchError(f"no reader for per-layer metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"gillbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names."""
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, object] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.workload["name"]


def resolve(bench: dict, workload: str) -> Cell:
    wl = _by_name(bench["workloads"], workload, "workload")
    conf = _by_name(bench["configs"], wl["config"], "configuration")
    config = load_json(bench_file(conf["file"]))
    tpath = os.path.join(BENCH_DIR, "traffic", f"{wl['traffic']}.json")
    if not os.path.exists(tpath):
        raise BenchError(f"no traffic mix file for {wl['traffic']!r}")
    traffic = load_json(tpath)
    e2e = [m for m in bench["end_to_end"] if applies(m, workload)]
    per_layer = [m for m in bench["per_layer"] if applies(m, workload)]
    cell = Cell(wl, config, traffic, e2e, per_layer)
    cell.readers = {m["name"]: load_metric(m["name"]) for m in per_layer}
    return cell


@dataclass
class Check:
    """One number compared against the plain reference, with its limit:
    the run is correct where every value lies at or under its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back to run.py."""
    attempted: int
    failed: int
    e2e: Dict[str, float]
    checks: List[Check]
    memory_peak_bytes: int
    device_kind: str
    layer_ctx: Optional[dict] = None     # trace runs: what readers read
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    notes: Dict[str, object] = field(default_factory=dict)


def result_line(cell: Cell, out: Outcome, trace: bool,
                control: bool = False) -> dict:
    """The last line of standard output. `correct` needs every check within
    its limit and at least one check made."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(out.layer_ctx or {})
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in out.e2e:
                metrics[m["name"]] = {"value": float(out.e2e[m["name"]]),
                                      "unit": m["unit"]}
    device = {"platform": "gpu", "kind": out.device_kind, "count": 1,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    if trace:
        device["busy_s"] = out.busy_s
        device["window_s"] = out.window_s
    line = {"correct": bool(out.checks) and all(c.ok for c in out.checks),
            "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": device}
    if control:
        line["control"] = True
    if trace and out.breakdown:
        line["breakdown"] = out.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    return line


def print_checks(checks: List[Check], stream=None) -> None:
    stream = sys.stderr if stream is None else stream
    for c in checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=stream)
    stream.flush()
