"""BENCHMARK.json against the contract's limits, and every cell's and
metric's files found by name, over whatever BENCHMARK.json holds."""

import json
import os
import re

import pytest

from portbench import check, data, run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


BENCH = _bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_top_level_keys():
    bench = BENCH
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines():
    bench = BENCH
    named = bench["configs"] + bench["workloads"] + bench["end_to_end"] \
        + bench["per_layer"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names)), kind
    assert len(set(METRICS)) == len(METRICS)
    for e in named:
        assert NAME.match(e["name"]), e["name"]
    lines = [c[k] for c in bench["configs"] for k in ("why", "source")] \
        + [w["why"] for w in bench["workloads"]] \
        + [m["layer"] for m in bench["per_layer"]] + bench["command"]
    for line in lines:
        assert 1 <= len(line) <= 200 and "\n" not in line \
            and "\t" not in line, line
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_entry_keys_and_counts():
    bench = BENCH
    assert 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert len(c["reduced"]) <= 16
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in bench["workloads"])
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    cells = set(CELLS)
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    spec = run.load_cell(cell)
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    moved = {m["moves"] for m in spec["per_layer"]}
    assert moved <= names


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = run.load_cell(cell)
    cfg = spec["config"]
    assert cfg["name"] == spec["cell"]["config"]
    assert spec["traffic"]["loop"] == "closed"
    assert isinstance(spec["traffic"]["entry"], str)
    kind = run.kind(cfg)
    for fn in ("answer", "work", "shape", "shrink"):
        assert callable(getattr(kind, fn))
    ref = check.reference(cfg["kind"])
    assert callable(ref.Judge) and callable(ref.digest)
    lim = check.limits(cell)
    assert lim["limits"] and all(v >= 0 for v in lim["limits"].values())
    assert set(lim["limits"]) <= set(lim["readings"]["lower"])
    assert len(data.column_dists(cfg["data"])) >= 1
    assert set(cfg["test_scale"]) >= {"rows", "train_rows"}


@pytest.mark.parametrize("metric", METRICS)
def test_every_metric_has_its_reader(metric):
    assert callable(run.reader(metric))


def test_config_sources_match_benchmark():
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
