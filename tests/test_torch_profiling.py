"""``KF2VEC_PROFILE_DIR`` in the port (``utils/profiling.py``): a k = 3
``train_model_set -device cpu`` of 3 epochs on each route (dense, FSW lazy
and FSW exact) writes one Chrome trace of its second epoch per clade under
``<dir>/train_model_clade_<c>/`` only when the variable is set, and its
checkpoints and CSVs are byte-identical to the run without it."""

import json
import os

import pytest
import torch

from kf2vecfsw_tpu_torch.cli import main
from kf2vecfsw_tpu_torch.utils.profiling import PROFILE_DIR_ENV, maybe_trace

from .test_torch_fsw_cli import _dataset, _train

torch.set_num_threads(1)

ROUTES = {"dense": ("-no_fsw",), "fsw_lazy": (), "fsw_exact": ("-fsw_lazy_refresh", "0")}


def _outputs(out_dir):
    return {f: (out_dir / f).read_bytes() for f in sorted(os.listdir(out_dir))
            if f.endswith((".ckpt", ".csv"))}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_trace_only_when_set_and_outputs_unchanged(tmp_path, monkeypatch, route):
    feats, sub, rows = _dataset(tmp_path, "genomes")
    if route == "dense":
        feats = str(tmp_path / "kf")
        os.makedirs(feats)
        main(["get_frequencies", "-input_dir", str(tmp_path / "genomes_fna"), "-output_dir", feats,
              "-k", "3", "-device", "cpu"])
    traces = tmp_path / "traces"
    monkeypatch.delenv(PROFILE_DIR_ENV, raising=False)
    _train(main, feats, sub, tmp_path, tmp_path / "plain", "-e", "3", *ROUTES[route])
    assert not traces.exists()
    monkeypatch.setenv(PROFILE_DIR_ENV, str(traces))
    _train(main, feats, sub, tmp_path, tmp_path / "traced", "-e", "3", *ROUTES[route])

    plain, traced = _outputs(tmp_path / "plain"), _outputs(tmp_path / "traced")
    assert len(plain) == 3 * len({c for _, c in rows})  # checkpoint, embeddings, distortions
    assert plain == traced
    clades = sorted({c for _, c in rows})
    assert sorted(os.listdir(traces)) == [f"train_model_clade_{c}" for c in clades]
    for c in clades:
        files = os.listdir(traces / f"train_model_clade_{c}")
        assert len(files) == 1 and files[0].endswith(".pt.trace.json")
        with open(traces / f"train_model_clade_{c}" / files[0]) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        assert any(n.startswith("aten::") for n in names)  # the epoch's ops on the host
        assert "aten::mm" in names or "aten::addmm" in names


def test_maybe_trace_is_free_when_unset(tmp_path, monkeypatch):
    monkeypatch.delenv(PROFILE_DIR_ENV, raising=False)
    with maybe_trace("tag", "cpu"):
        torch.ones(2).sum()
    assert os.listdir(tmp_path) == []
    monkeypatch.setenv(PROFILE_DIR_ENV, str(tmp_path))
    with maybe_trace("tag", "cpu"):
        torch.ones(2).sum()
    assert os.listdir(tmp_path) == ["tag"]
