"""What a run loads: nothing of JAX or the JAX package; the reference
nothing of the port. Each check runs in a fresh interpreter."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench_port.tests.tiny import CELLS

REPO = Path(__file__).resolve().parents[2]
ENV = {**os.environ, "PYTHONPATH": str(REPO)}


def python(code: str, cwd=REPO) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=ENV, capture_output=True,
                          text=True, timeout=600)


def test_rehearsal_loads_no_jax():
    code = f"""
import json, sys
from bench_port import harness
from bench_port.tests.tiny import overrides
for cell in {list(CELLS)!r}:
    harness.run_cell(cell, 5, 0.5, False, "cpu", **overrides(cell))
print(json.dumps(harness.forbidden_modules()))
"""
    out = python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_whole():
    out = python("import sys; sys.modules['kf2vecfsw_tpu_x'] = sys; sys.modules['jax.numpy'] = sys;"
                 "from bench_port.harness import forbidden_modules; print(forbidden_modules())")
    assert out.stdout.strip() == "['jax.numpy']"


def test_reference_loads_nothing_of_the_port():
    out = python("import sys; import bench_port.reference.models, bench_port.reference.kmers;"
                 "print(sorted(m for m in sys.modules if m.split('.')[0] in "
                 "('kf2vecfsw_tpu_torch', 'kf2vecfsw_tpu', 'jax')))")
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    from bench_port import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", CELLS)
def test_bare_checkout_fails(tmp_path, cell):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", cell, "--seed", "1",
                          "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    # past the look for a card, the run needs the port, which is not there
    out = subprocess.run([sys.executable, "-c", (
        "import sys; sys.path.insert(0, '.'); from bench_port import harness;"
        f"harness.run_cell({cell!r}, 1, 0.5, False, 'cpu')")], cwd=tmp_path,
        capture_output=True, text=True, timeout=600, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0 and "kf2vecfsw_tpu_torch" in out.stderr
