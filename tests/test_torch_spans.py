"""The port's spans (``kf2vecfsw_tpu_torch/utils/phases.py``) in its training
loop, on the CPU.

- Off (no collector, no profiler): ``phase()`` is one shared null context
  and never enters ``torch.profiler.record_function``; with a collector
  alone it times into the collector without it; with a recording profiler
  it marks ``kf2vec.<name>``.
- Under ``torch.profiler`` (CPU activity) every FSW route's epoch (lazy and
  exact, shared vocab and per genome) and the classifier's hold one
  ``train.step`` per batch with its forward, loss, backward and two adam
  spans inside it, one ``fsw.refresh`` per refresh with its stages inside
  it (``jvp`` once per refresh group), and no step overlapping a refresh.
- The parameters and the epoch loss are bit-identical with the spans
  recording and without.
- The daemon's ``phases_ms`` keys for a placement are the same with and
  without a recording profiler, and the same as before the training spans
  existed.

n = 10 items in batches of 4 (three steps), k = 3 (V = 32), base_dim 2, 8
slices, H 16, E 8; the lazy routes refresh every 2 steps in groups of 4
(two refreshes an epoch, three groups each)."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kf2vecfsw_tpu_torch.infer.cache import clear_all
from kf2vecfsw_tpu_torch.infer.serve import ServeDaemon
from kf2vecfsw_tpu_torch.kmer.vocab import FSW_BASE_MAP, canonical_vocab_codes, codes_to_digit_matrix
from kf2vecfsw_tpu_torch.models.fsw import FSWDistEmbed, init_fsw_dist_embed_
from kf2vecfsw_tpu_torch.models.mlp import Classifier, init_params_
from kf2vecfsw_tpu_torch.train.fsw_lazy import LazyPlanes, lazy_distance_epoch
from kf2vecfsw_tpu_torch.train.step import classifier_epoch, distance_epoch, make_adam
from kf2vecfsw_tpu_torch.utils import phases

from .test_torch_serve import _mk_library, _run_requests, _serve_args
from .test_torch_slice import _write_queries

torch.set_num_threads(1)

N, B, K, BASE, C, H, E = 10, 4, 3, 2, 8, 16, 8
V = len(canonical_vocab_codes(K))
REFRESH, GROUP = 2, 4
STEPS = math.ceil(N / B)
GROUPS = math.ceil(N / GROUP)
ROUTES = ("lazy_shared", "lazy_pergenome", "exact_shared", "exact_pergenome", "classifier")
STEP_PARTS = ("train.forward", "train.loss", "train.backward", "train.adam")


def _feats(route: str, gen: torch.Generator) -> torch.Tensor:
    if route.endswith("shared") or route == "classifier":
        w = torch.rand(N, V, generator=gen)
        return torch.where(w < 0.3, torch.zeros_like(w), w)  # absent k-mers
    x = torch.zeros(N, 24, K + 1)
    codes = canonical_vocab_codes(K)
    for i in range(N):
        m = min(8 + 2 * i, 24)  # point sets of 8-24 k-mers, zero-padded to 24
        pick = np.sort(np.random.default_rng(i).choice(codes, m, replace=False))
        x[i, :m, :K] = torch.from_numpy(codes_to_digit_matrix(pick, K, FSW_BASE_MAP)).float()
        w = torch.rand(m, generator=gen) + 0.01
        x[i, :m, K] = w / w.sum()
    return x


def _epoch(route: str):
    """A fresh model, optimizer and data of ``route``; returns (run the
    epoch -> loss, the model, the planes or None)."""
    gen = torch.Generator().manual_seed(7)
    feats = _feats(route, gen)
    order = torch.randperm(N, generator=gen)
    if route == "classifier":
        model = init_params_(Classifier(V, H, 3), gen)
        opt = make_adam(model, 1e-3)
        labels = torch.arange(N) % 3
        return (lambda: classifier_epoch(model, opt, feats, labels, order, B)[0]), model, None
    model = init_fsw_dist_embed_(FSWDistEmbed(K, BASE, C, H, E), gen)
    opt = make_adam(model, 1e-3)
    d = torch.rand(N, N, generator=gen)
    dist = d + d.T
    dist.fill_diagonal_(0)
    if route.startswith("exact"):
        return (lambda: distance_epoch(model, opt, feats, dist, order, B)), model, None
    planes = LazyPlanes(feats, route.endswith("shared"), REFRESH, STEPS, GROUP)
    return (lambda: lazy_distance_epoch(model, opt, planes, dist, order, B)), model, planes


def _spans(prof) -> dict[str, list[tuple[int, int]]]:
    out: dict[str, list[tuple[int, int]]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name().startswith(phases.PREFIX):
            start = e.start_ns()
            out.setdefault(e.name()[len(phases.PREFIX):], []).append(
                (start, start + e.duration_ns()))
    return out


def _within(inner: tuple[int, int], outer: list[tuple[int, int]]) -> bool:
    return any(s <= inner[0] and inner[1] <= e for s, e in outer)


def _overlaps(a: tuple[int, int], b: tuple[int, int]) -> bool:
    return a[0] < b[1] and b[0] < a[1]


def test_phase_off_is_one_shared_null_context(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    assert not torch.autograd._profiler_enabled()
    assert {id(phases.phase(n)) for n in ("train.step", "fsw.refresh", "parse")} == {
        id(phases._NULL)}
    with phases.phase("train.step") as got:
        assert got is None
    run, _, _ = _epoch("lazy_shared")
    run()
    assert calls == []
    with phases.collect() as ph:  # a collector alone: host seconds, no profiler mark
        with phases.phase("parse"):
            pass
    assert calls == [] and ph["parse"] >= 0.0
    with profile(activities=[ProfilerActivity.CPU]):
        with phases.phase("parse", "7"):
            pass
    assert calls == [("kf2vec.parse", "7")]


def test_phase_exception_passes_through_both_sinks():
    with phases.collect() as ph, profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with phases.phase("bad"):
                raise ValueError("raised inside a phase")
    assert "bad" in ph
    assert len(_spans(prof)["bad"]) == 1


@pytest.mark.parametrize("route", ROUTES)
def test_epoch_spans_nest(route):
    run, _, planes = _epoch(route)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = _spans(prof)
    steps = spans["train.step"]
    assert len(steps) == STEPS
    for part in STEP_PARTS:
        assert len(spans[part]) == STEPS * (2 if part == "train.adam" else 1), part
        assert all(_within(sp, steps) for sp in spans[part]), part
    assert "train.grad_sum" not in spans  # no process group
    refreshes = spans.get("fsw.refresh", [])
    assert len(refreshes) == (planes.refreshes if planes is not None else 0)
    if planes is None:
        assert not [n for n in spans if n.startswith("fsw.")]
        return
    assert len(refreshes) == 2
    shared = route.endswith("shared")
    stages = {"fsw.refresh.sort": 1 if shared else GROUPS, "fsw.refresh.jvp": GROUPS,
              "fsw.refresh.reduce": GROUPS, "fsw.refresh.gather": GROUPS if shared else 0}
    for stage, per_refresh in stages.items():
        assert len(spans.get(stage, [])) == per_refresh * len(refreshes), stage
        assert all(_within(sp, refreshes) for sp in spans.get(stage, [])), stage
    assert not any(_overlaps(s, r) for s in steps for r in refreshes)


@pytest.mark.parametrize("route", ROUTES)
def test_spans_change_no_bit(route):
    results = []
    for recording in (False, True):
        run, model, _ = _epoch(route)
        if recording:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                loss = run()
            assert _spans(prof)["train.step"]
        else:
            loss = run()
        results.append((loss, {k: v.detach().clone() for k, v in model.state_dict().items()}))
    (loss0, params0), (loss1, params1) = results
    assert torch.equal(loss0, loss1)
    assert params0.keys() == params1.keys()
    assert all(torch.equal(params0[k], params1[k]) for k in params0)


# the daemon's phases_ms keys of each placement, as they were before the
# training loop had spans
_PHASES = {"model_load", "parse", "transfer", "dispatch", "fetch", "format"}
PLACE_PHASES = {("dense", "place"): _PHASES,
                ("dense", "place_features"): _PHASES - {"transfer"},  # rows cached on the device
                ("fsw", "place"): _PHASES, ("fsw", "place_features"): _PHASES}


@pytest.mark.parametrize("kind", ["dense", "fsw"])
def test_daemon_phase_keys_unchanged(tmp_path, kind):
    k, v = 3, 32
    lib = str(tmp_path / "lib")
    _mk_library(lib, n_subtrees=2, v=v, fsw_k=k if kind == "fsw" else None, seed=4)
    fna = tmp_path / "fna"
    fna.mkdir()
    _write_queries(fna, np.random.default_rng(11), n=3)
    keys = []
    for recording in (False, True):
        clear_all()
        out, again = str(tmp_path / f"out{recording}"), str(tmp_path / f"again{recording}")
        daemon = ServeDaemon(_serve_args(lib, k=k, p=2))
        requests = [{"cmd": "warm"}, {"cmd": "place", "input_dir": str(fna), "output_dir": out},
                    {"cmd": "place_features", "features_dir": out, "output_dir": again},
                    {"cmd": "quit"}]
        if recording:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                resps = _run_requests(daemon, requests)
            assert "format" in _spans(prof)  # the placement's phases are marked too
        else:
            resps = _run_requests(daemon, requests)
        assert all(r["ok"] for r in resps), resps
        keys.append({"place": set(resps[2]["phases_ms"]),  # after the ready and warm replies
                     "place_features": set(resps[3]["phases_ms"])})
    assert keys[0] == keys[1]
    for cmd, got in keys[0].items():
        assert got == PLACE_PHASES[kind, cmd], cmd
