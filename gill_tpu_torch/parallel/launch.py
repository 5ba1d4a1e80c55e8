"""A group of rank processes on one host, each its own process group
member (what torch.distributed.run starts, with a join limit).

    results = run_ranks("pkg.module:function", world=2,
                        kwargs={...}, workdir=d, timeout=300, device="cpu")

Each rank is `python -m gill_tpu_torch.parallel.launch` with RANK,
WORLD_SIZE, LOCAL_RANK and LOCAL_WORLD_SIZE set and a file store under
`workdir` as its rendezvous (no TCP port, so concurrent groups never
collide). A rank calls `init_distributed(device, timeout=pg_timeout)`,
then `function(**kwargs)`, pickles the return value and destroys its
process group. The parent joins every rank by `timeout` seconds: a rank
that exits non-zero, or any rank still running at the limit, kills the
group and raises with the tail of every rank's log, so a deadlock fails
instead of hanging its caller.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

_JOB = "GILL_DIST_JOB"


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _tail(path: str, n: int = 3000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, 2)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def run_ranks(target: str, world: int, kwargs: Optional[Dict] = None, *,
              workdir: str, timeout: float, device: str = "cpu",
              pg_timeout: float = 120.0, pythonpath: Sequence[str] = (),
              threads: int = 1) -> List[Any]:
    """Runs `target` ("module:function") on `world` ranks and returns each
    rank's return value, in rank order. `device` is the ranks' device
    ("cpu" or "cuda"; ranks sharing a card take gloo). `pg_timeout`:
    seconds a collective waits; `timeout`: seconds the group may take
    from its start. `threads`: torch's intra-op threads a rank."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    job = os.path.join(workdir, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump({"target": target, "kwargs": kwargs or {},
                     "device": device, "pg_timeout": pg_timeout,
                     "threads": threads, "workdir": workdir,
                     "store": store}, f)
    path = [_repo_root(), *pythonpath]
    if os.environ.get("PYTHONPATH"):
        path.append(os.environ["PYTHONPATH"])
    procs, logs = [], []
    try:
        for r in range(world):
            e = dict(os.environ)
            e.update({"RANK": str(r), "WORLD_SIZE": str(world),
                      "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(world),
                      _JOB: job,
                      "PYTHONPATH": os.pathsep.join(path),
                      "OMP_NUM_THREADS": str(threads)})
            log = os.path.join(workdir, f"rank{r}.log")
            logs.append(log)
            with open(log, "wb") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "gill_tpu_torch.parallel.launch"],
                    env=e, stdout=out, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(
                    f"rank(s) {bad} of {target} failed (exit "
                    f"{[codes[r] for r in bad]}):\n" + _logs(logs))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{target} on {world} ranks did not finish in "
                    f"{timeout} s (a hung or diverged rank):\n" + _logs(logs))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"result{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _logs(logs) -> str:
    return "\n".join(f"--- rank {r} ---\n{_tail(p)}"
                     for r, p in enumerate(logs))


def _main() -> None:
    import torch
    import torch.distributed as dist

    from gill_tpu_torch.parallel.mesh import init_distributed

    with open(os.environ[_JOB], "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(job["threads"])
    init_distributed(job["device"], timeout=job["pg_timeout"],
                     init_method="file://" + job["store"])
    mod, fn = job["target"].split(":")
    result = getattr(importlib.import_module(mod), fn)(**job["kwargs"])
    rank = dist.get_rank()
    tmp = os.path.join(job["workdir"], f"result{rank}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, os.path.join(job["workdir"], f"result{rank}.pkl"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _main()
