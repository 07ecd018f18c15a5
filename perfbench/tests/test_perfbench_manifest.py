"""The manifest and every file it names load by name and keep to the
benchmark's contract: names, units, keys, bounds, the run budget, and
each per-layer metric reported beside the end-to-end metric it moves."""

import importlib.util
import json
import math
import re

import pytest

from perfbench import harness

MAN = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["perfbench"]
    assert len(MAN["command"]) <= 32
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_run_budget_fits_24_cells():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MAN[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = harness.load_cell(cell, MAN)
    assert c.limits and all(v >= 0 for v in c.limits.values())
    assert harness.traffic_module(c.kind).run
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_layer_metrics_report_what_they_move(cell):
    c = harness.load_cell(cell, MAN)
    reported = {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert m["moves"] in reported, (cell, m["name"])


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["end_to_end"]
                                    + MAN["per_layer"]])
def test_metric_reader_loads_and_reads_nothing_from_nothing(metric):
    path = harness.HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read({}) is None


def test_metric_workloads_name_cells():
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        for w in m.get("workloads", []):
            assert w in CELLS


def test_four_chip_cells_are_few():
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, math.floor(len(CELLS) * 0.25))
