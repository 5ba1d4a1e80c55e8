"""gillbench: the benchmark of gill_tpu_torch, the PyTorch and CUDA port of
GILL, on NVIDIA H100 cards.

One run measures one cell of BENCHMARK.json:

    python3 -m gillbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer metric
lives in a file of its own that the harness finds by the name BENCHMARK.json
gives it: configs/<config>.json, traffic/<traffic>.json (read by the driver
that the mix names, drivers/<driver>.py), metrics/<metric>.py. reference/ holds
the plain PyTorch reference that decides `correct`; it imports nothing of the
port.
"""
