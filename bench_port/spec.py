"""The benchmark's declarations, found by name.

``BENCHMARK.json`` at the repo root lists the cells, the end-to-end metrics
and the per-layer metrics. Everything that belongs to one configuration, one
traffic mix, one cell or one per-layer metric sits in a file of its own
under this folder, named after it:

- ``configs/<config>.json``: the model's sizes as run;
- ``traffic/<mix>.json``: the mix's parameters and the driver that runs it;
- ``limits/<cell>.json``: the limits of the cell's comparison numbers;
- ``drivers/<driver>.py``: one general driver per kind of window;
- ``metrics/<metric>.py``: the reader of one per-layer metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(REPO / "BENCHMARK.json")


def cell(name: str) -> dict:
    """A cell of ``BENCHMARK.json``."""
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return _json(HERE / "limits" / f"{cell_name}.json")


def driver(name: str):
    return importlib.import_module(f"bench_port.drivers.{name}")


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py`` (metric names hold
    dots, so the file is loaded by path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(cell_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it under ``workloads``, and those without that key."""
    return [m for m in benchmark()[kind]
            if cell_name in m.get("workloads", [cell_name])]
