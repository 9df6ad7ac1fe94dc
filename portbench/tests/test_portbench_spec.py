"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, limits file and per-layer metric is found by name."""

import json
import os
import re

import pytest

from portbench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    files = harness.cell_files(SPEC, cell["name"])
    for key in ("config", "traffic", "limits"):
        assert os.path.isfile(files[key]), files[key]
    with open(files["traffic"]) as f:
        mix = json.load(f)
    assert os.path.isfile(os.path.join(harness.HERE, "drivers", mix["driver"] + ".py"))
    with open(files["limits"]) as f:
        limits = json.load(f)["numbers"]
    assert limits and all("limit" in v for v in limits.values())
    reported = harness.metric_names(SPEC, cell["name"], "end_to_end")
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert harness.metric_names(SPEC, cell["name"], "per_layer")


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(metric["name"]).read)
    assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}


def test_names_units_and_bounds():
    names = [x["name"] for kind in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[kind]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    configs = {c["name"] for c in SPEC["configs"]}
    assert {w["config"] for w in SPEC["workloads"]} == configs
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
