"""The port's `serve` daemon (kf2vecfsw_tpu_torch/infer/serve.py) on the CPU.

- The protocol and watchdog cases of tests/test_serve.py against the port's
  ServeDaemon, on a library saved by the JAX package: clean JSON lines, zero
  new checkpoint or anchor misses on a second placement, errors that leave
  the loop serving, the watchdog's timeout reply and its warm floor.
- Parity with the JAX daemon: both place the same raw genomes (k=3) against
  the same dense and FSW libraries. `.kf` and `.npy` bytes equal;
  classes.out within rtol 1e-5; APPLES and `.emb` values within the
  tolerances of tests/test_torch_slice*.py (rtol 1e-4, atol 1e-6 dense and
  1e-5 FSW).
- The watchdog's cancel flag: an abandoned handler writes nothing after its
  timeout reply, and the next request is served.
- An error in a later subtree (a corrupt checkpoint) leaves the earlier
  subtree's two files complete, equal to a run without the fault.
- `python -m kf2vecfsw_tpu_torch serve -device cpu` prints only JSON lines on
  stdout and exits 0.
"""

import glob
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.cli import build_parser as jax_build_parser
from kf2vecfsw_tpu.infer.cache import clear_all as jax_clear_all
from kf2vecfsw_tpu.infer.serve import ServeDaemon as JaxServeDaemon
from kf2vecfsw_tpu.io.kf import write_kf as jax_write_kf
from kf2vecfsw_tpu.models.fsw import init_fsw_dist_embed
from kf2vecfsw_tpu.models.mlp import init_classifier, init_dist_embed
from kf2vecfsw_tpu.train.checkpoint import save_checkpoint
from kf2vecfsw_tpu.train.distance import f32_row as jax_f32_row
from kf2vecfsw_tpu_torch.cli import build_parser
from kf2vecfsw_tpu_torch.infer import query as port_query
from kf2vecfsw_tpu_torch.infer.cache import clear_all
from kf2vecfsw_tpu_torch.infer.serve import ServeDaemon
from kf2vecfsw_tpu_torch.utils.cancel import Cancelled

from .test_torch_slice import _read_emb, _read_table, _write_queries

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, H, E, NB = 64, 32, 16, 8


def _mk_library(lib, n_subtrees=2, v=V, fsw_k=None, seed=0):
    """A small library saved by the JAX package: a classifier and n subtree
    models (dense, or FSW at fsw_k) with NB anchors each."""
    os.makedirs(lib, exist_ok=True)
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(3 + seed)
    save_checkpoint(
        os.path.join(lib, "classifier_model.ckpt"), "NeuralNetClassifierOnly",
        {"model_input_size": v, "model_hidden_size_fc1": H, "model_class_count": n_subtrees},
        jax.device_get(init_classifier(key, v, H, n_subtrees)),
    )
    for c in range(n_subtrees):
        key, sub = jax.random.split(key)
        path = os.path.join(lib, f"model_subtree_{c}.ckpt")
        if fsw_k:
            save_checkpoint(path, "NeuralNetFSW", {
                "model_input_size": fsw_k + 1, "model_hidden_size_fc1": H,
                "model_embedding_size": E, "fsw_k": fsw_k, "fsw_base_dim": 3, "fsw_out_dim": 12},
                jax.device_get(init_fsw_dist_embed(sub, fsw_k, 3, 12, H, E)))
        else:
            save_checkpoint(path, "NeuralNet", {
                "model_input_size": v, "model_hidden_size_fc1": H, "model_embedding_size": E},
                jax.device_get(init_dist_embed(sub, v, H, E)))
        with open(os.path.join(lib, f"embeddings_subtree_{c}.csv"), "w") as f:
            for i in range(NB):
                f.write(f"g{i}\t" + jax_f32_row(rng.normal(size=E).astype(np.float32)))


def _mk_queries(qdir, n=6, seed=5):
    os.makedirs(qdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        jax_write_kf(os.path.join(qdir, f"q{i}.kf"), [(f"q{i}", rng.random(V) / V)])


def _serve_args(lib, parser=build_parser, device="cpu", **over):
    argv = ["serve", "-classifier_model", lib, "-distance_model", lib]
    for k, v in over.items():
        argv += [f"-{k}", str(v)]
    if device:
        argv += ["-device", device]
    return parser().parse_args(argv)


def _run_requests(daemon, requests, stdout=None):
    """Drive the daemon loop over in-memory pipes; returns parsed responses
    (including the leading ready event)."""
    stdin = io.StringIO("".join(json.dumps(r) + "\n" for r in requests))
    stdout = stdout if stdout is not None else io.StringIO()
    daemon.serve(stdin=stdin, stdout=stdout)
    return [json.loads(line) for line in stdout.getvalue().splitlines()]  # raises if logs leaked


def test_serve_protocol_and_warm_cache_reuse(tmp_path):
    clear_all()
    lib = str(tmp_path / "lib")
    _mk_library(lib)
    q1, q2 = str(tmp_path / "q1"), str(tmp_path / "q2")
    o1, o2 = str(tmp_path / "o1"), str(tmp_path / "o2")
    _mk_queries(q1, seed=5)
    _mk_queries(q2, seed=6)  # a different fresh query set for request 2
    remap = str(tmp_path / "remap.tsv")
    with open(remap, "w") as f:
        f.write("label\tnew_label\nq0\tRENAMED_Q0\n")

    daemon = ServeDaemon(_serve_args(lib))
    resps = _run_requests(daemon, [
        {"cmd": "ping"},
        {"cmd": "warm"},
        {"cmd": "place_features", "features_dir": q1, "output_dir": o1, "remap": remap},
        {"cmd": "stats"},
        {"cmd": "place_features", "features_dir": q2, "output_dir": o2},
        {"cmd": "stats"},
        {"cmd": "quit"},
    ])
    ready, pong, warm, place1, stats1, place2, stats2, bye = resps
    assert ready["event"] == "ready" and ready["subtree_models"] == 2
    assert pong["pong"] is True
    assert warm["ok"] and warm["models"] == 3 and warm["compiled"] == 2
    param_bytes = 4 * ((V + 1) * H + (H + 1) * 2 + 2 * ((V + 1) * H + (H + 1) * E))
    assert warm["device_bytes"] == param_bytes + 2 * 4 * NB * E
    assert sorted(warm) == ["compiled", "device_bytes", "models", "ok", "seconds"]
    assert place1["ok"] and place1["queries"] == 6
    assert sorted(place1) == ["dispatches", "ok", "outputs", "phases_ms", "queries", "seconds"]
    assert {"model_load", "dispatch", "fetch", "format"} <= set(place1["phases_ms"])
    assert place1["dispatches"] >= 2
    assert os.path.exists(os.path.join(o1, "classes.out"))
    mats1 = glob.glob(os.path.join(o1, "apples_input_di_mtrx_subtree_*.csv"))
    assert mats1
    all_rows = "".join(open(m).read() for m in mats1)
    assert "RENAMED_Q0" in all_rows and "\nq0\t" not in all_rows  # remap applied
    assert place2["ok"]
    assert glob.glob(os.path.join(o2, "apples_input_di_mtrx_subtree_*.csv"))
    assert bye["bye"] is True
    assert sorted(stats1["caches"]) == ["anchors", "checkpoints", "kf_rows"]
    assert sorted(stats1["caches"]["kf_rows"]) == ["entries", "hits", "host_bytes", "misses"]

    # fresh query set, warm models: request 2 adds ZERO checkpoint or anchor misses
    for kind in ("checkpoints", "anchors"):
        assert stats2["caches"][kind]["misses"] == stats1["caches"][kind]["misses"], kind
        assert stats2["caches"][kind]["hits"] > stats1["caches"][kind]["hits"]
    assert daemon.requests == 6  # ping, warm, 2 places, 2 stats
    assert stats2["requests"] == 5  # reported before its own increment


def test_serve_errors_keep_loop_alive(tmp_path):
    clear_all()
    lib = str(tmp_path / "lib")
    _mk_library(lib)
    daemon = ServeDaemon(_serve_args(lib))
    resps = _run_requests(daemon, [
        {"cmd": "place_features", "features_dir": str(tmp_path / "nope"),
         "output_dir": str(tmp_path / "o")},
        {"cmd": "frobnicate"},
        "not json at all",  # json.dumps makes this a JSON string: no cmd
        # stage code may sys.exit on a missing input dir (reference CLI
        # behavior): the daemon must contain SystemExit, not die
        {"cmd": "place", "input_dir": str(tmp_path / "nofna"), "output_dir": str(tmp_path / "o2")},
        {"cmd": "ping"},
    ])
    assert resps[0]["event"] == "ready"
    assert resps[1]["ok"] is False and "FileNotFoundError" in resps[1]["error"]
    assert resps[2]["ok"] is False and "frobnicate" in resps[2]["error"]
    assert resps[2]["commands"] == ["ping", "place", "place_features", "stats", "warm", "quit"]
    assert resps[3]["ok"] is False
    assert resps[4]["ok"] is False and "SystemExit" in resps[4]["error"]
    assert resps[5]["pong"] is True  # still serving after four failures


def test_serve_fsw_library_places_point_sets(tmp_path):
    """An FSW subtree model is served when the {name}_k{k}.npy point sets
    sit beside the .kf features."""
    clear_all()
    k = 3
    lib = str(tmp_path / "lib")
    _mk_library(lib, n_subtrees=1, fsw_k=k)
    rng = np.random.default_rng(7)
    qdir = str(tmp_path / "q")
    _mk_queries(qdir, n=3)
    for i in range(3):
        n_pts = 5 + i
        pts = np.concatenate([rng.integers(0, 4, size=(n_pts, k)), rng.random((n_pts, 1))], axis=1)
        np.save(os.path.join(qdir, f"q{i}_k{k}.npy"), pts.astype(np.float32))
    daemon = ServeDaemon(_serve_args(lib, k=k))
    out = str(tmp_path / "o")
    resps = _run_requests(daemon, [
        {"cmd": "warm"},
        {"cmd": "place_features", "features_dir": qdir, "output_dir": out},
    ])
    assert resps[1]["ok"] and resps[1]["compiled"] == 2, resps[1]
    assert resps[2]["ok"], resps[2]
    mat = open(os.path.join(out, "apples_input_di_mtrx_subtree_0.csv")).read()
    assert mat.splitlines()[0].startswith("\t")
    assert len(mat.splitlines()) == 4  # header + 3 queries


def test_serve_request_watchdog_contains_wedged_handler(tmp_path, monkeypatch):
    """A request wedged inside a device call (mocked by a handler that sleeps
    past the deadline) is answered {ok: false, timeout: true} while the
    daemon keeps serving."""
    clear_all()
    lib = str(tmp_path / "lib")
    _mk_library(lib)
    monkeypatch.setattr(ServeDaemon, "handle_place", lambda self, req: time.sleep(60))
    daemon = ServeDaemon(_serve_args(lib, request_timeout=0.2))
    assert daemon.request_timeout_s == 0.2
    t0 = time.monotonic()
    resps = _run_requests(daemon, [
        {"cmd": "place", "input_dir": "x", "output_dir": str(tmp_path / "o")},
        {"cmd": "ping"},
        {"cmd": "stats"},
        {"cmd": "quit"},
    ])
    assert time.monotonic() - t0 < 30  # the 60 s sleep was not waited out
    ready, wedged, pong, stats, bye = resps
    assert wedged["ok"] is False and wedged.get("timeout") is True
    assert "watchdog" in wedged["error"]
    assert pong["pong"] is True
    assert stats["request_timeouts"] == 1
    assert bye["bye"] is True


def test_serve_watchdog_env_knob_and_errors_propagate(tmp_path, monkeypatch):
    """The env knob enables the watchdog when the flag is unset; handler
    exceptions under the watchdog surface as normal error replies."""
    clear_all()
    lib = str(tmp_path / "lib")
    _mk_library(lib)

    def boom(self, req):
        raise ValueError("bad input dir")

    monkeypatch.setattr(ServeDaemon, "handle_place", boom)
    monkeypatch.setenv("KF2VEC_SERVE_REQUEST_TIMEOUT_S", "5")
    daemon = ServeDaemon(_serve_args(lib))
    assert daemon.request_timeout_s == 5.0
    ready, err, pong, bye = _run_requests(daemon, [
        {"cmd": "place", "input_dir": "x", "output_dir": "y"},
        {"cmd": "ping"},
        {"cmd": "quit"},
    ])
    assert err["ok"] is False and "bad input dir" in err["error"]
    assert "timeout" not in err
    assert pong["pong"] is True


def test_serve_warm_gets_longer_watchdog_floor(tmp_path, monkeypatch):
    """warm may run long (a first nvcc build of the kernels): a
    placement-scale -request_timeout does not cut it; it gets the
    KF2VEC_SERVE_WARM_TIMEOUT_S floor instead."""
    clear_all()
    lib = str(tmp_path / "lib")
    _mk_library(lib)

    def slow_warm(self, req):
        time.sleep(0.5)
        return {"ok": True, "models": 0, "compiled": 0, "seconds": 0.5, "device_bytes": 0}

    monkeypatch.setattr(ServeDaemon, "handle_warm", slow_warm)
    monkeypatch.setattr(ServeDaemon, "handle_place", lambda self, req: time.sleep(0.5))
    monkeypatch.setenv("KF2VEC_SERVE_WARM_TIMEOUT_S", "5")
    daemon = ServeDaemon(_serve_args(lib, request_timeout=0.2))
    ready, warm, place, bye = _run_requests(daemon, [
        {"cmd": "warm"},
        {"cmd": "place", "input_dir": "x", "output_dir": "y"},
        {"cmd": "quit"},
    ])
    assert warm["ok"] is True  # 0.5 s warm survives the 0.2 s request timeout
    assert place["ok"] is False and place.get("timeout") is True  # places don't


def _classes(path):
    _, rows = _read_table(path)
    return rows


@pytest.mark.parametrize("kind", ["dense", "fsw"])
def test_port_daemon_matches_the_jax_daemon(tmp_path, kind):
    """Both daemons `place` the same 6 raw genomes (k=3: V = 32) against one
    library and then `place_features` them again."""
    k, v = 3, 32
    lib = str(tmp_path / "lib")
    _mk_library(lib, n_subtrees=3, v=v, fsw_k=k if kind == "fsw" else None, seed=4)
    fna = tmp_path / "fna"
    fna.mkdir()
    _write_queries(fna, np.random.default_rng(11))
    outs = {}
    for tag, daemon_cls, parser, device in (("jax", JaxServeDaemon, jax_build_parser, None),
                                             ("port", ServeDaemon, build_parser, "cpu")):
        jax_clear_all()
        clear_all()
        out, again = str(tmp_path / f"out_{tag}"), str(tmp_path / f"again_{tag}")
        daemon = daemon_cls(_serve_args(lib, parser=parser, device=device, k=k, p=2))
        resps = _run_requests(daemon, [
            {"cmd": "warm"},
            {"cmd": "place", "input_dir": str(fna), "output_dir": out},
            {"cmd": "place_features", "features_dir": out, "output_dir": again},
            {"cmd": "quit"},
        ])
        assert all(r["ok"] for r in resps), resps
        outs[tag] = (out, again, resps)
    (out_j, again_j, r_j), (out_p, again_p, r_p) = outs["jax"], outs["port"]
    for a, b in zip(r_j, r_p):  # the same reply keys
        assert sorted(a) == sorted(b)
        if "phases_ms" in a:
            assert set(b["phases_ms"]) <= set(a["phases_ms"]) | {"transfer"}
    assert r_p[1]["models"] == r_j[1]["models"] == 4
    exts = (".kf", f"_k{k}.npy") if kind == "fsw" else (".kf",)
    feats = sorted(f for f in os.listdir(out_j) if f.endswith(exts))
    assert len(feats) == 6 * len(exts)
    assert feats == sorted(f for f in os.listdir(out_p) if f.endswith(exts))
    for f in feats:
        assert open(os.path.join(out_p, f), "rb").read() == open(os.path.join(out_j, f), "rb").read()
    atol = 1e-5 if kind == "fsw" else 1e-6
    for d_j, d_p in ((out_j, out_p), (again_j, again_p)):
        cls_j, cls_p = _classes(os.path.join(d_j, "classes.out")), _classes(os.path.join(d_p, "classes.out"))
        assert sorted(cls_j) == sorted(cls_p) == [f"q{i}" for i in range(6)]
        for g in cls_j:
            np.testing.assert_allclose(cls_p[g][2:], cls_j[g][2:], rtol=1e-5, atol=1e-7)
            assert cls_p[g][0] == cls_j[g][0]
        apples = sorted(f for f in os.listdir(d_j) if f.startswith("apples_input"))
        assert apples and apples == sorted(f for f in os.listdir(d_p) if f.startswith("apples_input"))
        for f in apples:
            h_j, m_j = _read_table(os.path.join(d_j, f))
            h_p, m_p = _read_table(os.path.join(d_p, f))
            emb = f.replace("apples_input_di_mtrx_subtree_", "embedding_subtree_").replace(".csv", ".emb")
            e_j, e_p = _read_emb(os.path.join(d_j, emb)), _read_emb(os.path.join(d_p, emb))
            assert h_j == h_p and list(m_j) == list(m_p) and list(e_j) == list(e_p)
            for g in m_j:
                np.testing.assert_allclose(m_p[g], m_j[g], rtol=1e-4, atol=atol)
                np.testing.assert_allclose(e_p[g], e_j[g], rtol=1e-4, atol=atol)


def _snapshot(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def test_an_abandoned_handler_writes_nothing_after_its_timeout_reply(tmp_path, monkeypatch):
    """A placement whose block load outlasts the watchdog (the first one
    sleeps 4 s against a 1.5 s deadline) gets the timeout reply; the
    abandoned handler then wakes, computes the block and is refused at its
    first write: the output directory after it ended equals the one at the
    reply. The next placement is served in full."""
    clear_all()
    lib, qdir = str(tmp_path / "lib"), str(tmp_path / "q")
    _mk_library(lib)
    _mk_queries(qdir)
    out, out2 = str(tmp_path / "o"), str(tmp_path / "o2")

    real_loader = port_query._kf_gather_loader
    slept = []

    def slow_loader(qmat):
        load = real_loader(qmat)

        def slow(ids):
            if not slept:
                slept.append(1)
                time.sleep(4.0)
            return load(ids)

        return slow

    monkeypatch.setattr(port_query, "_kf_gather_loader", slow_loader)
    real_query, errors = port_query.query_func, []

    def recording_query(*args, **kw):
        try:
            return real_query(*args, **kw)
        except BaseException as e:
            errors.append(e)
            raise

    monkeypatch.setattr(port_query, "query_func", recording_query)

    at_reply = []

    class Pipe(io.StringIO):
        def write(self, s):
            if '"timeout": true' in s:
                at_reply.append(_snapshot(out))
            return super().write(s)

    daemon = ServeDaemon(_serve_args(lib, request_timeout=1.5))
    before = set(threading.enumerate())  # other tests' abandoned workers may still sleep
    resps = _run_requests(daemon, [
        {"cmd": "place_features", "features_dir": qdir, "output_dir": out},
        {"cmd": "place_features", "features_dir": qdir, "output_dir": out2},
        {"cmd": "quit"},
    ], stdout=Pipe())
    workers = [t for t in threading.enumerate() if t.name == "serve-request" and t not in before]
    for t in workers:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in workers)
    ready, timed_out, placed, bye = resps
    assert timed_out["ok"] is False and timed_out["timeout"] is True
    assert placed["ok"] is True and bye["bye"] is True
    assert len(errors) == 1 and isinstance(errors[0], Cancelled)
    (snap,) = at_reply
    assert _snapshot(out) == snap  # nothing written after the reply
    apples = [f for f in snap if f.startswith("apples_input")]
    assert apples and all(snap[f].count(b"\n") == 1 for f in apples)  # headers only
    assert "Computation Completed" not in snap["query_run.log"].decode()
    assert _classes(os.path.join(out2, "classes.out")).keys() == {f"q{i}" for i in range(6)}


@pytest.mark.parametrize("query_matrix", [True, False])
def test_an_error_in_a_later_subtree_keeps_earlier_files_whole(tmp_path, monkeypatch,
                                                                 query_matrix):
    """Subtree 0's three blocks (one query each) are still pending when
    subtree 1's corrupt checkpoint fails to load: its two files are written
    whole before the error is raised, equal to a run without the fault."""
    from kf2vecfsw_tpu_torch.infer.query import query_func

    if not query_matrix:
        monkeypatch.setenv("KF2VEC_NO_QUERY_MATRIX", "1")
    clear_all()
    good, bad, qdir = str(tmp_path / "good"), str(tmp_path / "bad"), str(tmp_path / "q")
    _mk_library(good)
    shutil.copytree(good, bad)
    with open(os.path.join(bad, "model_subtree_1.ckpt"), "wb") as f:
        f.write(b"not a checkpoint")
    _mk_queries(qdir)
    files = sorted(glob.glob(os.path.join(qdir, "*.kf")))
    runs = {}
    for tag, lib in (("good", good), ("bad", bad)):
        out = tmp_path / f"out_{tag}"
        out.mkdir()
        (out / "classes.out").write_text(
            "genome\ttop_class\ttop_p\n" + "".join(f"q{i}\t{0 if i < 3 else 1}.0\t1.0\n" for i in range(6)))
        if tag == "good":
            query_func(qdir, files, lib, str(out), 28, str(out), block_size=1, device="cpu")
        else:
            with pytest.raises(ValueError, match="model_subtree_1"):
                query_func(qdir, files, lib, str(out), 28, str(out), block_size=1, device="cpu")
        runs[tag] = out
    for f in ("apples_input_di_mtrx_subtree_0.csv", "embedding_subtree_0.emb"):
        whole = (runs["good"] / f).read_bytes()
        assert whole.count(b"\n") == (4 if f.endswith(".csv") else 3)
        assert (runs["bad"] / f).read_bytes() == whole, f
    assert not (runs["bad"] / "apples_input_di_mtrx_subtree_1.csv").exists()


def test_the_serve_cli_prints_only_json_lines(tmp_path):
    lib, qdir = str(tmp_path / "lib"), str(tmp_path / "q")
    _mk_library(lib)
    _mk_queries(qdir)
    requests = [{"cmd": "ping"},
                {"cmd": "place_features", "features_dir": qdir, "output_dir": str(tmp_path / "o")},
                {"cmd": "quit"}]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "kf2vecfsw_tpu_torch", "serve", "-classifier_model", lib,
         "-distance_model", lib, "-device", "cpu", "-warm", "-p", "1"],
        input="".join(json.dumps(r) + "\n" for r in requests), cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r.get("event") for r in lines] == ["ready", None, None, None]
    assert lines[1]["pong"] and lines[2]["ok"] and lines[2]["queries"] == 6 and lines[3]["bye"]
