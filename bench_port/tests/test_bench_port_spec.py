"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import re

import pytest

from bench_port import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
BENCH = spec.benchmark()
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
PER_LAYER = BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in PER_LAYER:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_setup_s_and_run_seconds():
    assert E2E["setup_s"]["bound"] <= 0.25 and "workloads" not in E2E["setup_s"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in spec.metrics_of(cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(cell, "per_layer")


@pytest.mark.parametrize("metric", [m["name"] for m in PER_LAYER])
def test_per_layer_cells_report_what_it_moves(metric):
    m = next(p for p in PER_LAYER if p["name"] == metric)
    moved = E2E[m["moves"]]
    for cell in m.get("workloads", CELLS):
        assert cell in moved.get("workloads", CELLS), (metric, cell)


def test_rooflines_have_a_step_share_beside_them():
    for m in PER_LAYER:
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"
            assert any("mfu" in o["name"] and o["moves"] == m["moves"] for o in PER_LAYER)


def test_layers_named_alike():
    layers = {m["layer"] for m in PER_LAYER}
    assert layers == {"kernels", "device", "model step", "lazy FSW"}


@pytest.mark.parametrize("cell", CELLS)
def test_files_found_by_name(cell):
    w = spec.cell(cell)
    cfg = spec.config(w["config"])
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert cfg["name"] == w["config"] and cfg["reduced"] == entry["reduced"]
    assert entry["file"] == f"bench_port/configs/{w['config']}.json"
    mix = spec.traffic(w["traffic"])
    assert hasattr(spec.driver(mix["driver"]), "Run")
    assert set(spec.limits(cell)) >= {"kf_gap"} or set(spec.limits(cell)) >= {"loss_gap"}
    for m in spec.metrics_of(cell, "per_layer"):
        assert callable(spec.metric_reader(m["name"]))


def test_command_and_paths():
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench_port/")

