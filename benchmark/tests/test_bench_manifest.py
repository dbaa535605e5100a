"""BENCHMARK.json as the benchmark's contract has it: names and units of
the allowed letters, every file found by name, each per-layer metric moving
an end-to-end metric that each of its cells reports, at most one cell in
four on four chips."""
import json
import math
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
BENCH = os.path.join(ROOT, "benchmark")
M = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = M["end_to_end"] + M["per_layer"]
CELLS = {w["name"]: w for w in M["workloads"]}


def reported(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"] and M["command"][1:] == [
        "benchmark/run.py"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)


def test_names_and_units():
    names = [x["name"] for x in METRICS + M["workloads"] + M["configs"]]
    names += [w[k] for w in M["workloads"] for k in ("config", "traffic")]
    names += [k for c in M["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    for group in (METRICS, M["workloads"], M["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    assert len(json.dumps(M).encode()) <= 64 * 1024


def test_lines_are_short():
    texts = [w["why"] for w in M["workloads"]] + [
        c["source"] for c in M["configs"]] + [m["layer"] for m in M[
            "per_layer"]] + M["command"]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)


@pytest.mark.parametrize("cfg", M["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert cfg["file"].startswith("benchmark/configs/")
    data = json.load(open(os.path.join(ROOT, cfg["file"])))
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in M["workloads"])


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_cell_files_and_metrics(cell):
    name = cell["name"]
    assert cell["chips"] in (1, 4)
    for path in (os.path.join(BENCH, "traffic", cell["traffic"] + ".json"),
                 os.path.join(BENCH, "limits", name + ".json")):
        assert os.path.isfile(path), path
    e2e = [m for m in M["end_to_end"] if reported(m, name)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = [m for m in M["per_layer"] if reported(m, name)]
    assert layer


def test_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in M["per_layer"]:
        # each per-layer metric names its cells (`harness.cell` reads them)
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        assert os.path.isfile(os.path.join(BENCH, "layer_metrics",
                                           m["name"] + ".py"))
        for cell in m["workloads"]:
            assert cell in CELLS and reported(e2e[m["moves"]], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"] \
                or "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_four_chip_cells():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, math.floor(0.25 * len(M["workloads"])))
