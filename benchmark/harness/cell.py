"""What a cell is made of, found by the names in ``BENCHMARK.json``: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``) and the entry point that serves it
(``entries/<entry>.py``, named by the mix, with ``make(mix, ctx)``), the
limits of its output check (``limits/<cell>.json``), its end-to-end metrics
and the readers of its per-layer metrics (``metrics/<metric>.py``, each with
``read(trace)``)."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SPEC = os.path.join(ROOT, "BENCHMARK.json")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(SPEC)


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[w['name'] for w in spec['workloads']]}")


def config(name: str) -> dict:
    return load_json(os.path.join(BENCH, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    return load_json(os.path.join(BENCH, "traffic", f"{name}.json"))


def limits(cell: str) -> dict:
    return load_json(os.path.join(BENCH, "limits", f"{cell}.json"))


def reports(metric: dict, cell: str) -> bool:
    """Whether ``metric`` (an entry of ``end_to_end`` or ``per_layer``) is
    reported in ``cell``: its ``workloads``, else every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(spec: dict, cell: str) -> list[dict]:
    return [m for m in spec["end_to_end"] if reports(m, cell)]


def per_layer(spec: dict, cell: str) -> list[dict]:
    """The per-layer metrics of ``cell``: those that list it, and those that
    list no cells and move an end-to-end metric the cell reports."""
    moved = {m["name"] for m in end_to_end(spec, cell)}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def module(folder: str, name: str):
    """The module ``<folder>/<name>.py`` of the benchmark, loaded by its path
    (a name may hold dots)."""
    path = os.path.join(BENCH, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name}", path)
    loaded = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loaded)
    return loaded


def reader(metric: str):
    """The ``read(trace)`` of ``metrics/<metric>.py``."""
    return module("metrics", metric).read


def entry(name: str):
    """The ``make(mix, ctx)`` of ``entries/<name>.py``."""
    return module("entries", name).make
