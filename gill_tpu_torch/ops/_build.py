"""Builds the hand-written CUDA kernels in csrc/ and loads them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by nvcc
for Hopper (`-gencode arch=compute_90a,code=sm_90a`) into
`csrc/build/lib<name>-<hash>.so` (a directory .gitignore lists), the hash
taken over the source and every `csrc/*.cuh`, so a changed source or
header never reuses a stale library. `build_all()` starts one
nvcc per source at once and waits for all of them. A failed build RAISES
with the compiler's output: there is no fallback to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("flash_attn", "geglu", "w8_matmul", "decode_attn", "ln_matmul",
           "flash_mma", "mm_probe", "flash_variants")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# compiler reports (ptxas register/shared-memory lines) of this process
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of gill_tpu_torch are built from csrc/ at first use")


def _lib_path(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names=SOURCES) -> Dict[str, float]:
    """Compiles every missing library in parallel (one nvcc per source).
    Returns {name: seconds} for the libraries built by this call."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs: List[Tuple[str, str, str, subprocess.Popen, float]] = []
    for name in names:
        src, out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), time.perf_counter()))
    took = {}
    errors = []
    for name, out, tmp, proc, t0 in procs:
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _, out = _lib_path(name)
            if not os.path.exists(out):
                build_all((name,))
            lib = ctypes.CDLL(out)
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raises on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
