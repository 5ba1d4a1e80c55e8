"""Spans from the benchmark's own wrappers, and one profiled slice.

`Recorder.wrap(obj, attr, name, attrs=...)` replaces a function of the port
with one that, while the recorder is on, notes a host span (name, attributes
from the call's shapes, thread, perf_counter ns) and opens a profiler range
`gb:<i>` so that the kernels it launches can be told apart. The spans are
the benchmark's: nothing is added inside the program.

`Slice` runs torch.profiler (CPU and CUDA activity, every thread) over a
short steady part of the window. Its raw events are reduced here to:
kernels (name, start, duration, stream) on the device, each attributed to
every span open on its launching thread at the launch; the device's busy
union; the idle gaps, named by the span the host was in.
"""

from __future__ import annotations

import contextlib
import functools
import heapq
import threading
import time
from collections import Counter
from typing import Callable, Dict, List, Optional

# runtime and driver launch calls (names may carry a version suffix, as
# cudaLaunchKernelExC_v11060)
_LAUNCH = ("cudaLaunch", "cuLaunch")


class Recorder:
    """Host spans of the benchmark's wrappers; off until `on()`."""

    def __init__(self):
        self.active = False
        self.spans: List[dict] = []
        self._lock = threading.Lock()
        self._undo: List[Callable] = []

    def on(self):
        with self._lock:
            self.spans = []
            self.active = True

    def off(self) -> List[dict]:
        with self._lock:
            self.active = False
            return list(self.spans)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        if not self.active:
            yield
            return
        import torch

        with self._lock:
            idx = len(self.spans)
            rec = {"name": name, "attrs": attrs, "idx": idx,
                   "tid": threading.get_ident(), "t0": time.perf_counter_ns(),
                   "t1": None}
            self.spans.append(rec)
        try:
            with torch.profiler.record_function(f"gb:{idx}"):
                yield
        finally:
            rec["t1"] = time.perf_counter_ns()

    def wrap(self, obj, attr: str, name: str,
             attrs: Optional[Callable] = None):
        """Wraps obj.attr; `attrs(*args, **kw)` gives the span's attributes
        from the call (shapes; never a device read)."""
        orig = getattr(obj, attr)

        @functools.wraps(orig)
        def wrapper(*args, **kw):
            if not self.active:
                return orig(*args, **kw)
            a = attrs(*args, **kw) if attrs is not None else {}
            with self.span(name, **a):
                return orig(*args, **kw)

        setattr(obj, attr, wrapper)
        self._undo.append(lambda: setattr(obj, attr, orig))

    def unwrap_all(self):
        while self._undo:
            self._undo.pop()()


class Slice:
    """torch.profiler over a slice of the window, read as raw Kineto
    events (no per-event Python objects beyond the raw list)."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.wall_s = None
        self.raw = None
        self._t0 = None

    def start(self):
        import torch
        from torch._C import _profiler as P

        try:
            exp = P._ExperimentalConfig(profile_all_threads=True)
        except TypeError:            # an older torch: this thread only
            exp = P._ExperimentalConfig()
        self._cfg = P.ProfilerConfig(P.ProfilerState.KINETO, False, False,
                                     False, False, False, exp)
        self._acts = {P.ProfilerActivity.CPU}
        if self.cuda:
            self._acts.add(P.ProfilerActivity.CUDA)
        torch.autograd._prepare_profiler(self._cfg, self._acts)
        torch.autograd._enable_profiler(self._cfg, self._acts)
        self._t0 = time.perf_counter()

    def stop(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.raw = torch.autograd._disable_profiler().events()
        return self


def reduce_events(raw, spans: List[dict], owners=()) -> dict:
    """Kernels with the spans each was launched in, the busy union and the
    idle gaps of one slice. `raw`: Kineto events (or any objects with the
    same methods); `spans`: the recorder's spans of the slice; `owners`:
    (kernel name part, span name) pairs, the wrapper span a kernel of that
    name is launched in. A launch the profiler files under no thread that
    holds that span (the port's ctypes libraries launch outside any torch
    operator) goes to the one thread holding such a span open at the
    launch, the span whose head dim matches the kernel's where several
    do (`_owned`)."""
    from torch.autograd import DeviceType

    ranges, launches, dev = {}, {}, []
    for e in raw:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # the profiler's own device-side copies of the gb: ranges are
            # not work on the card
            if not (name.startswith("gb:") or e.is_user_annotation()):
                dev.append((e.start_ns(), e.duration_ns(), name,
                            e.correlation_id(), e.device_resource_id()))
        elif name.startswith("gb:"):
            ranges.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns(),
                 int(name[3:])))
        elif name.startswith(_LAUNCH):
            launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    owner = _launch_spans(ranges, launches)
    names = {s["idx"]: s["name"] for s in spans}
    kernels = [{"name": name, "start": start, "dur": dur, "stream": stream,
                "spans": owner.get(corr, ())}
               for start, dur, name, corr, stream in dev]
    if owners:
        owned = _Owned(ranges, spans)
        for k, (_, _, name, corr, _) in zip(kernels, dev):
            want = next((sp for part, sp in owners if part in name), None)
            if want is None or corr not in launches or any(
                    names.get(i) == want for i in k["spans"]):
                continue
            k["spans"] = owned.find(want, launches[corr][1], name)
    kernels.sort(key=lambda k: k["start"])
    busy, gaps = _union(kernels)
    by_idx = {s["idx"]: s["name"] for s in spans}
    named = [(by_idx.get(idx, "none") if idx is not None else "none",
              (g1 - g0) / 1e9)
             for (g0, g1), idx in zip(gaps, _open_at(ranges, gaps))]
    named.sort(key=lambda x: -x[1])
    by_name = Counter()
    for k in kernels:
        by_name[k["name"][:120]] += k["dur"] / 1e9
    return {"kernels": kernels, "busy_s": busy / 1e9,
            "attributed": sum(bool(k["spans"]) for k in kernels),
            "gaps": named,
            "device_ops": [[n, s] for n, s in by_name.most_common(10)],
            "idle_gaps": [[n, s] for n, s in named[:10]]}


def _launch_spans(ranges, launches) -> dict:
    """correlation id -> the spans open on the launching thread at the
    launch, outermost first. A thread's spans nest (context managers), so
    one sweep with a stack of open spans a thread does it."""
    by_tid = {}
    for corr, (tid, t) in launches.items():
        by_tid.setdefault(tid, []).append((t, 1, corr, 0))
    owner = {}
    for tid, evs in by_tid.items():
        evs = evs + [(a, 0, idx, b) for a, b, idx in ranges.get(tid, ())]
        evs.sort()
        stack = []
        for t, kind, key, end in evs:
            while stack and stack[-1][1] < t:
                stack.pop()
            if kind == 0:
                stack.append((key, end))
            elif stack:
                owner[key] = tuple(k for k, _ in stack)
    return owner


class _Owned:
    """The spans open at a host time, on whichever thread holds a span of
    a given name then."""

    def __init__(self, ranges, spans):
        import bisect

        self._bisect = bisect.bisect_right
        self.attrs = {s["idx"]: s["attrs"] for s in spans}
        names = {s["idx"]: s["name"] for s in spans}
        self.stack = {}             # idx -> its enclosing spans and itself
        self.by_name = {}           # name -> [(start, end, idx)] a thread
        for rs in ranges.values():
            open_ = []
            for a, b, idx in sorted(rs):
                while open_ and open_[-1][1] < a:
                    open_.pop()
                open_.append((idx, b))
                self.stack[idx] = tuple(i for i, _ in open_)
            per = {}
            for a, b, idx in rs:
                per.setdefault(names.get(idx), []).append((a, b, idx))
            for n, lst in per.items():
                self.by_name.setdefault(n, []).append(sorted(lst))

    def find(self, name: str, t: int, kernel: str) -> tuple:
        hits = []
        for lst in self.by_name.get(name, ()):
            j = self._bisect(lst, (t, float("inf"), 0)) - 1
            if j >= 0 and lst[j][1] >= t:
                hits.append(lst[j][2])
        if len(hits) > 1:
            d = _head_dim(kernel)
            hits = [i for i in hits if self.attrs.get(i, {}).get("d") == d]
        return self.stack[hits[0]] if len(hits) == 1 else ()


def _head_dim(kernel: str):
    """The head dim a flash kernel's name carries (flash_mma<false, 40, ...>,
    flash_f32<64>), or None."""
    import re

    m = re.search(r"flash_mma<[^,<>]+,\s*(\d+)|flash_f32<(\d+)", kernel)
    return int(m.group(1) or m.group(2)) if m else None


def _open_at(ranges, gaps) -> list:
    """For each gap (in time order), the latest-started span of any thread
    still open at its start, or None."""
    allr = sorted(r for rs in ranges.values() for r in rs)
    heap, out, i = [], [], 0
    for g0, _ in gaps:
        while i < len(allr) and allr[i][0] <= g0:
            a, b, idx = allr[i]
            heapq.heappush(heap, (-a, b, idx))
            i += 1
        while heap and heap[0][1] < g0:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def _union(kernels):
    """(busy ns, idle gaps [(start, end)]) of device intervals."""
    busy, gaps, cur = 0, [], None
    for k in kernels:
        a, b = k["start"], k["start"] + k["dur"]
        if cur is None:
            cur = [a, b]
        elif a > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, gaps


def device_ms_by_span(red: dict, spans: List[dict], name: str,
                      kernel_has: tuple = ()) -> Dict[int, float]:
    """Device ms of the kernels launched inside each span called `name`,
    nested spans' kernels included (only kernels whose name holds one of
    `kernel_has`, if given)."""
    ids = {s["idx"] for s in spans if s["name"] == name}
    out: Dict[int, float] = {}
    for k in red["kernels"]:
        if kernel_has and not any(h in k["name"] for h in kernel_has):
            continue
        for idx in k["spans"]:
            if idx in ids:
                out[idx] = out.get(idx, 0.0) + k["dur"] / 1e6
    return out
