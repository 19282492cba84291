"""The port stands alone: importing every module of kf2vecfsw_tpu_torch and
chip_smoke.py loads neither jax nor any module of the JAX package, its text
I/O runs on its own C++ library and never loads the JAX package's
(libkf2vec_io.so), and the entry points run on the card by default, raising
when there is none."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import kf2vecfsw_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(kf2vecfsw_tpu_torch.__path__, "kf2vecfsw_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
import numpy as np
from kf2vecfsw_tpu_torch.io.fasta import encode_bases
from kf2vecfsw_tpu_torch.io.kf import read_kf, write_kf
from kf2vecfsw_tpu_torch.train.distance import f32_row
write_kf(sys.argv[1], [("g", np.arange(4.0)), ("h", np.ones(4) / 3)])
read_kf(sys.argv[1])
f32_row(np.ones(3, np.float32))
encode_bases(b"ACGT")
with open("/proc/self/maps") as f:
    maps = f.read()
print(json.dumps({"modules": mods, "loaded": sorted(sys.modules),
                  "textio": "libtextio-" in maps, "jax_native": "libkf2vec_io" in maps}))
"""


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(tmp_path / "probe.kf")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout
    report = json.loads(out.strip().splitlines()[-1])
    assert "kf2vecfsw_tpu_torch.cli" in report["modules"]
    for mod in ("kernels.histogram", "kernels.sort", "models.fsw", "ingest.kmers",
                "utils.membudget", "train.distance", "train.step", "tree.newick",
                "tree.cluster", "tree.distance", "ingest.tree_ops", "ops.losses",
                "train.schedule", "train.resume", "train.classifier", "io.native.lib",
                "io.kf", "io.fasta", "infer.cache", "infer.classify", "infer.query",
                "infer.serve", "utils.phases", "utils.prefetch", "utils.cancel",
                "parallel.mesh", "parallel.counting", "parallel.mp_check", "models.zoo",
                "utils.profiling"):
        assert f"kf2vecfsw_tpu_torch.{mod}" in report["modules"]
    assert report["textio"] and not report["jax_native"]
    loaded = report["loaded"]
    assert "jax" not in loaded and not any(m.startswith("jax.") for m in loaded)
    assert "kf2vecfsw_tpu" not in loaded
    assert not [m for m in loaded if m.startswith("kf2vecfsw_tpu.")]


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    with open(os.path.join(REPO, "chip_smoke.py"), "rb") as src:
        (tmp_path / "chip_smoke.py").write_bytes(src.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from kf2vecfsw_tpu_torch.cli import main
    from kf2vecfsw_tpu_torch.device import resolve_device
    from kf2vecfsw_tpu_torch.infer.classify import classify_func
    from kf2vecfsw_tpu_torch.infer.query import query_func
    from kf2vecfsw_tpu_torch.ingest.frequencies import get_frequencies
    from kf2vecfsw_tpu_torch.ingest.kmers import get_kmers
    from kf2vecfsw_tpu_torch.kmer.counter import KmerCounter
    from kf2vecfsw_tpu_torch.train.classifier import train_classifier_func
    from kf2vecfsw_tpu_torch.train.distance import train_model_set_func

    d = str(tmp_path)
    for call in (
        lambda: resolve_device(),
        lambda: KmerCounter(7),
        lambda: get_frequencies(d, d, k=5),
        lambda: get_kmers(d, d, k=5),
        lambda: get_kmers(d, d, k=17),
        lambda: classify_func(d, [], d, 28, d),
        lambda: query_func(d, [], d, d, 28, d),
        lambda: main(["get_frequencies", "-input_dir", d, "-output_dir", d]),
        lambda: main(["get_kmers", "-input_dir", d, "-output_dir", d]),
        lambda: main(["process_query_data", "-input_dir", d, "-output_dir", d,
                      "-classifier_model", d, "-distance_model", d]),
        lambda: train_classifier_func(d, [], d, 1, 8, 4, 1e-3, 1e-6, 2000, 28, False, d),
        lambda: train_model_set_func(d, [], d, d, 1, 8, 4, 4, 1e-3, 1e-6, 2000, None, 28, d,
                                     use_fsw=False),
        lambda: main(["train_classifier", "-input_dir", d, "-subtrees", d, "-o", d]),
        lambda: main(["train_model_set", "-input_dir", d, "-subtrees", d, "-o", d, "-no_fsw"]),
        lambda: train_model_set_func(d, [], d, d, 1, 8, 4, 4, 1e-3, 1e-6, 2000, None, 28, d),
        lambda: main(["train_model_set", "-input_dir", d, "-subtrees", d, "-o", d]),
        lambda: main(["build_library", "-input_dir", d, "-output_dir", d, "-tree", d]),
        lambda: main(["serve", "-classifier_model", d, "-distance_model", d]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")
    assert os.listdir(d) == []  # nothing ran on the CPU instead
