"""One run of one cell.

    python3 -m gillbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Refuses to run (exit 3, no result) without as many CUDA cards as the cell
asks for; there is no CPU fallback. Prints progress and every compared
number beside its limit on standard error, and as the last line of standard
output one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), device (and
with --trace 1 a breakdown), and last the checks. Exits 4, with no result,
if a module of JAX or of the JAX package is loaded once the window has
closed.

--control runs the cell's lower-precision control (the program's own lower
precision where it has one, else the reference's); it is for measuring a
limit and is never part of the benchmark's runs.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def log(msg: str) -> None:
    print(f"[gillbench {time.perf_counter() - T_PROCESS:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m gillbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    return ap.parse_args(argv)


def run_cell(cell, *, seed, seconds, trace, device, control=False,
             fault=None, t_process=None):
    """Drives one cell on `device` and returns (result line, outcome). The
    look for a card is the caller's (`main`); tests call this on the CPU."""
    import importlib

    from gillbench.drivers.common import RunSpec
    from gillbench.harness import result_line

    driver = importlib.import_module(
        f"gillbench.drivers.{cell.traffic['driver']}")
    spec = RunSpec(cell=cell, seed=seed, seconds=seconds, trace=bool(trace),
                   device=device, control=control, fault=fault,
                   t_process=T_PROCESS if t_process is None else t_process,
                   log=log)
    out = driver.run(spec)
    return result_line(cell, out, bool(trace), control=control), out


def main(argv=None) -> int:
    args = parse(argv)
    from gillbench import harness

    harness.set_cache_env()
    try:
        cell = harness.resolve(harness.load_benchmark(), args.workload)
    except (harness.BenchError, OSError, KeyError, ValueError) as e:
        print(f"gillbench: {e}", file=sys.stderr)
        return 2
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gillbench: the cell needs {chips} CUDA card(s); this machine "
              f"has {n}. No result.", file=sys.stderr)
        return 3
    from gillbench import roofline

    log(f"{args.workload} seed {args.seed} seconds {args.seconds} trace "
        f"{args.trace}{' control' if args.control else ''}; "
        f"{roofline.smi_line()}; torch {torch.__version__}")
    line, out = run_cell(cell, seed=args.seed, seconds=args.seconds,
                         trace=args.trace, device=torch.device("cuda", 0),
                         control=args.control)
    bad = harness.forbidden_modules()
    if bad:
        print(f"gillbench: forbidden modules loaded: {', '.join(bad)}. "
              f"No result.", file=sys.stderr)
        return 4
    log(f"notes {json.dumps(out.notes, default=str)}")
    harness.print_checks(out.checks)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
