"""Timing helpers and the card's published peaks, shared by the probe
scripts and chip_smoke.py.

Counterpart of the `timed` helper every script of scripts/ copies: those
run n copies of a call inside one compiled `scan` and take the delta
between two values of n, so that the time is the device's. Here a call is
an eager PyTorch call:
  * `cuda_ms` / `delta_ms`: n back-to-back calls between two CUDA events,
    after the device spins ~10 ms (`torch.cuda._sleep`) while the host
    queues them, so the host's launch overhead is not timed; `delta_ms`
    takes the delta between two values of n, as the scripts do;
  * `cuda_ms_cycled`: the same, with the calls cycling through distinct
    copies of their operands (`cold_copies` of them, >= 2x the L2 in all),
    so that each call reads operands no recent call touched: the L2-cold
    time of a call whose real caller streams a new operand each time (a
    decode step's next layer);
  * `host_and_device_ms`: for a call the host cannot get ahead of (a full
    UNet call issues thousands of launches), the host-clock ms of a call
    and the device-busy ms from torch.profiler, two numbers under two
    names.
On the CPU (the tests) `delta_ms`, `cycled_ms` and `host_and_device_ms`
read the host clock and report no device time.
"""

from __future__ import annotations

import itertools
import math
import subprocess
import time

import torch

# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
# the L2 cache (NVIDIA H100 SXM data sheet)
L2_BYTES = 50e6
# exponentials a second on the special-function units (FlashAttention-3,
# Shah et al. 2024: 3.9 TFLOPS of special functions on the H100 SXM5;
# 16 a clock on each of 132 SMs at 1.83 GHz)
EXP_S = 3.9e12


def smi_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def bound(nbytes: float, flops: float, kind: str, more=(), exps: float = 0):
    """(ms, "bytes" | "operations" | "exp"): the least time the card could
    take, the largest of the bytes over the memory rate, the operations
    over their peak rate (`more` adds (operations, kind) pairs run at other
    peak rates) and `exps` exponentials over the special-function rate.
    A max, not a sum: the three units run concurrently."""
    terms = {"bytes": nbytes / HBM_BYTES_S,
             "operations": sum(f / PEAK_FLOPS[k]
                               for f, k in ((flops, kind), *more)),
             "exp": exps / EXP_S}
    by = max(terms, key=terms.get)
    return 1e3 * terms[by], by


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of `fn` over `reps` back-to-back calls
    between two CUDA events, after one warm-up (see `_events_ms`)."""
    fn()
    torch.cuda.synchronize()
    return _events_ms(fn, reps) / reps


def cold_copies(nbytes: int) -> int:
    """How many distinct copies of an operand of `nbytes` bytes hold >= 2x
    the L2 in all (at least 2): cycling through them, every call finds its
    copy out of the L2."""
    return max(2, math.ceil(2 * L2_BYTES / nbytes))


def cuda_ms_cycled(fns, reps: int) -> float:
    """Mean device milliseconds a call over `reps` back-to-back calls (a
    multiple of len(fns) is rounded up to) that cycle through `fns`, each
    reading its own copy of the operands, after one warm-up call of each
    (see `_events_ms`)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    n = -(-reps // len(fns)) * len(fns)
    it = itertools.cycle(fns)
    return _events_ms(lambda: next(it)(), n) / n


def cycled_ms(fns, device, reps: int) -> float:
    """`cuda_ms_cycled` on CUDA; on the CPU the host-clock mean of `reps`
    calls cycling through `fns`, after one warm-up call of each."""
    if torch.device(device).type == "cuda":
        return cuda_ms_cycled(fns, reps)
    for fn in fns:
        fn()
    it = itertools.cycle(fns)
    return _host_ms(lambda: next(it)(), reps) / reps


def _events_ms(fn, n: int) -> float:
    """Device milliseconds of n back-to-back calls between two CUDA
    events. The device first spins ~10 ms (torch.cuda._sleep) while the
    host queues the calls, so the host's launch overhead is not timed."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def _host_ms(fn, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e3 * (time.perf_counter() - t0)


def delta_ms(fn, device, n1: int = 2, n2: int = 12) -> float:
    """Milliseconds a call: (time of n2 calls - time of n1 calls) / (n2 -
    n1), after one warm-up call. On CUDA the times are CUDA events with the
    device kept busy while the host queues the calls; on the CPU, the host
    clock."""
    fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        t1, t2 = _events_ms(fn, n1), _events_ms(fn, n2)
    else:
        t1, t2 = _host_ms(fn, n1), _host_ms(fn, n2)
    return max((t2 - t1) / (n2 - n1), 1e-6)


def device_profile(fn, top: int = 8, sums=()) -> dict:
    """torch.profiler's device trace of `fn`: the share of the device's
    active span (first kernel start to last kernel end) in which some
    kernel or copy ran (None when the trace holds no device events), the
    number of device events, the `top` kernels by device time (us) and, for
    each substring in `sums`, the device us of the events whose name holds
    it (`sum_us`)."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if not spans:
        return {"busy_share": None, "device_events": 0, "top_us": {},
                "sum_us": {k: 0.0 for k in sums}}
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    by_name = Counter()
    for e in events:
        by_name[e.name[:60]] += e.time_range.elapsed_us()
    return {"busy_share": busy / max(cur_e - spans[0][0], 1e-9),
            "device_events": len(spans), "active_span_us":
            cur_e - spans[0][0], "busy_us": busy,
            "top_us": dict(by_name.most_common(top)),
            "sum_us": {k: sum(e.time_range.elapsed_us() for e in events
                              if k in e.name) for k in sums}}


def host_and_device_ms(fn, device, reps: int = 3):
    """(host-clock ms a call, device-busy ms of one profiled call or None
    off CUDA): the mean of `reps` synchronised calls after a warm-up, then
    one call under torch.profiler."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    host = 1e3 * (time.perf_counter() - t0) / reps
    if not cuda:
        return host, None
    return host, device_profile(fn)["busy_us"] / 1e3


def clock_note(device) -> str:
    """What the times of a probe run are, printed at its top."""
    if torch.device(device).type == "cuda":
        return (f"# device: {torch.cuda.get_device_name(0)}; device ms from "
                f"CUDA events unless labelled host")
    return "# device: cpu (plain versions); every time is the host clock"


def probe_main(probe, doc: str, argv, device, **kw) -> int:
    """A probe script's main: `--out PATH` (write the rows as JSON there;
    nothing is written without it), on CUDA the card's name and power limit
    first, then `probe(device=device, **kw)`. Exit code 1 when a row says
    the card could not run it."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--out", help="also write the rows as JSON here")
    args = ap.parse_args(argv)
    if torch.device(device).type == "cuda":
        print(smi_line(), flush=True)
    rows = probe(device=device, **kw)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 1 if any("failed" in r for r in rows) else 0
