"""``BENCHMARK.json`` keeps to the benchmark's contract, and the harness finds
every configuration, traffic mix, entry, limit and per-layer reader by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark.harness import cell

SPEC = cell.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_entry_keys():
    assert set(SPEC) == TOP
    assert os.path.getsize(cell.SPEC) <= 64 * 1024
    for section, keys in KEYS.items():
        for entry in SPEC[section]:
            allowed = keys | ({"workloads"} if section in ("end_to_end", "per_layer") else set())
            assert keys <= set(entry) <= allowed, (section, entry["name"])


def test_command_paths_and_run_seconds():
    assert 1 <= len(SPEC["command"]) <= 32 and all(line(w) for w in SPEC["command"])
    assert all(not w.startswith("/") and ".." not in w.split("/") for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.rstrip("/").endswith("_torch")
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert line(e[key]), (e["name"], key)


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files)) and 1 <= len(SPEC["configs"]) <= 24
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in SPEC["paths"])
        conf = cell.config(c["name"])
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_end_to_end_bounds():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_what_it_must():
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in cell.end_to_end(SPEC, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer(SPEC, w["name"]), w["name"]


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_what_its_cells_report(metric):
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert metric["moves"] in e2e
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    cells = metric.get("workloads", [w["name"] for w in SPEC["workloads"]])
    for name in cells:
        assert cell.reports(e2e[metric["moves"]], name), (metric["name"], name)
    assert callable(cell.reader(metric["name"]))


def test_layers_are_named_alike():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    perf = open(os.path.join(cell.ROOT, "PERF.md")).read()
    for layer in layers:
        assert f"`{layer}`" in perf, layer


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_the_harness_finds_each_cell_by_name(w):
    conf = cell.config(w["config"])
    mix = cell.traffic(w["traffic"])
    limits = cell.limits(w["name"])
    assert os.path.exists(os.path.join(cell.ROOT, conf["scene"]))
    assert callable(cell.entry(mix["entry"]))
    assert set(limits) == {"rel_l2_max"} and 0 < limits["rel_l2_max"] < 1
    assert conf["assumed"] and conf["acquisition"]
