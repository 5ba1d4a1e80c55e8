"""BENCHMARK.json against the rules its schema sets, and every name in it
resolved to its file.

    python -m pytest gillbench/ -q
"""

import json
import os
import re

import pytest

from gillbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(harness.BENCHMARK_JSON) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_check_fits_the_day(bench):
    """A full check of 24 cells at this run length fits 43,200 s."""
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            if "better" in e:
                assert e["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in bench[group]}) == len(bench[group])
    metrics = [e["name"] for e in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("gillbench/") and c["file"] not in files
        files.add(c["file"])
        body = harness.load_json(harness.bench_file(c["file"]))
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16


def test_workloads(bench):
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert harness.applies(e2e[m["moves"]], w)
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert re.match(r"^[a-z0-9]+_roofline", m["name"])
    for w in cells:
        got = [m for m in bench["end_to_end"] if harness.applies(m, w)]
        assert "setup_s" in [m["name"] for m in got] and len(got) >= 2
        assert any(harness.applies(m, w) for m in bench["per_layer"])
        # a whole-step share of the peak beside the kernels' rooflines
        assert any("mfu" in m["name"] for m in bench["per_layer"]
                   if harness.applies(m, w))


def test_every_cell_resolves_by_name(bench):
    for w in bench["workloads"]:
        cell = harness.resolve(bench, w["name"])
        assert cell.traffic["driver"] == "gill_online"
        for m in cell.per_layer:
            r = cell.readers[m["name"]]
            assert (r.LAYER, r.UNIT, r.MOVES) == (m["layer"], m["unit"],
                                                  m["moves"])
            assert callable(r.read)


def test_layers_named_alike(bench):
    by_layer = {}
    for m in bench["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_unknown_workload_refused(bench):
    with pytest.raises(harness.BenchError):
        harness.resolve(bench, "no_such_cell")


def test_result_line_has_checks_last():
    cell = harness.Cell({"name": "x"}, {}, {}, [
        {"name": "setup_s", "unit": "s"}], [])
    out = harness.Outcome(attempted=3, failed=0, e2e={"setup_s": 1.5},
                          checks=[harness.Check("gap", 0.1, 0.2)],
                          memory_peak_bytes=7, device_kind="card")
    line = harness.result_line(cell, out, trace=False)
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert line["metrics"]["setup_s"] == {"value": 1.5, "unit": "s"}
    assert json.loads(json.dumps(line)) == line
    out.checks = [harness.Check("gap", float("nan"), 0.2)]
    assert harness.result_line(cell, out, trace=False)["correct"] is False
    out.checks = []
    assert harness.result_line(cell, out, trace=False)["correct"] is False
