"""What a run does before and after the cell: it refuses without a card, it
fails in a checkout that holds only the benchmark, and nothing it loads is
JAX or the JAX package."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from gillbench import harness

ENV = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=harness.ROOT)


def _run(code, cwd=harness.ROOT, timeout=600):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=ENV,
                          capture_output=True, text=True, timeout=timeout)


def test_refuses_without_a_card():
    p = subprocess.run(
        [sys.executable, "-m", "gillbench.run", "--workload",
         "gill_gen_c32", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, env=ENV, capture_output=True,
        text=True, timeout=300)
    assert p.returncode == 3
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_unknown_workload_exits_without_result():
    p = subprocess.run(
        [sys.executable, "-m", "gillbench.run", "--workload", "nope",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, env=ENV, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_fails_with_only_the_benchmark(tmp_path):
    """A checkout of BENCHMARK.json and gillbench/ alone (no port): with a
    card pretended, the run fails and prints no result."""
    shutil.copy(harness.BENCHMARK_JSON, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH_DIR, tmp_path / "gillbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "sys.argv = ['run', '--workload', 'gill_gen_c32', '--seed', '3',"
            " '--seconds', '1', '--trace', '0']\n"
            "runpy.run_module('gillbench.run', run_name='__main__')\n")
    env = dict(ENV, PYTHONPATH=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
    assert "gill_tpu_torch" in p.stderr


def test_runs_load_no_jax():
    """The tiny cell end to end, then the loaded modules by whole
    top-level name."""
    code = ("import json, torch\n"
            "from gillbench import tiny, run, harness\n"
            "run.run_cell(tiny.cell(), seed=2**31 + 3, seconds=0.5,"
            " trace=0, device=torch.device('cpu'))\n"
            "import gill_tpu_torch.api\n"
            "print(json.dumps(harness.forbidden_modules()))\n")
    p = _run(code)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_traced_run_reads_its_layers():
    """The tiny cell with --trace 1 on the CPU: the slice is profiled and
    reduced, and each reader of BENCHMARK.json's cell reads or stays out
    (no device here, so the trace readers find no kernel)."""
    import torch

    from gillbench import run, tiny

    bench = harness.load_benchmark()
    metrics = [m for m in bench["per_layer"]
               if harness.applies(m, "gill_gen_c32")]
    line, out = run.run_cell(tiny.cell(metrics), seed=2 ** 31 + 23,
                             seconds=0.6, trace=1,
                             device=torch.device("cpu"))
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) <= {m["name"] for m in metrics}
    assert line["metrics"]["sd_batch_latents.gen"]["value"] > 0
    assert {"unet_call_ms.gen", "k2_roofline.gen", "k3_roofline.gen",
            "device_idle_share.gen"}.isdisjoint(line["metrics"])
    assert out.layer_ctx["spans"] and "busy_s" in line["device"]


@pytest.mark.parametrize("var", ["TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"])
def test_caches_inside_the_checkout(var, monkeypatch):
    monkeypatch.delenv(var, raising=False)
    harness.set_cache_env()
    assert os.environ[var].startswith(harness.BENCH_DIR + os.sep)
