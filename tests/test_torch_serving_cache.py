"""The port's serving caches (kf2vecfsw_tpu_torch/infer/cache.py), phase
collector and prefetcher: the cases of tests/test_serving_cache.py that are
not TPU artefacts (the anchor-bucket padding is one, and is not ported).

A stale checkpoint is never served after its file changes, the caches never
hold more than their budget, a CPU entry and a card entry never meet, and
classify+query through the device-resident query matrix write the bytes of
the block-by-block route (KF2VEC_NO_QUERY_MATRIX=1)."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.models.mlp import init_classifier, init_dist_embed
from kf2vecfsw_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from kf2vecfsw_tpu_torch.infer import cache
from kf2vecfsw_tpu_torch.infer.cache import DeviceFileCache, cached_checkpoint, read_kf_files_cached
from kf2vecfsw_tpu_torch.io.kf import read_kf_files, write_kf
from kf2vecfsw_tpu_torch.train.distance import f32_row
from kf2vecfsw_tpu_torch.utils import phases
from kf2vecfsw_tpu_torch.utils.prefetch import prefetch_iter

import jax

CPU = torch.device("cpu")


def _touch(path, payload=b"x"):
    with open(path, "wb") as f:
        f.write(payload)


def test_hit_and_miss(tmp_path):
    p = str(tmp_path / "a.bin")
    _touch(p)
    c = DeviceFileCache(budget_bytes=lambda dev: 1 << 20)
    calls = []

    def build():
        calls.append(1)
        return torch.zeros(16)

    v1 = c.get(p, build)
    v2 = c.get(p, build)
    assert v1 is v2 and len(calls) == 1
    assert c.hits == 1 and c.misses == 1 and c.nbytes == 64


def test_entries_are_kept_per_device(tmp_path):
    p = str(tmp_path / "a.bin")
    _touch(p)
    c = DeviceFileCache(budget_bytes=lambda dev: 1 << 20)
    on_cpu = c.get(p, lambda: np.zeros(4), "cpu")
    on_card = c.get(p, lambda: np.ones(4), "cuda")  # a key only: nothing runs on a card
    assert on_card is not on_cpu and c.misses == 2 and len(c) == 2
    assert c.get(p, lambda: None, "cpu") is on_cpu and c.get(p, lambda: None, "cuda") is on_card


def test_invalidation_on_file_change(tmp_path):
    p = str(tmp_path / "a.bin")
    _touch(p, b"one")
    c = DeviceFileCache(budget_bytes=lambda dev: 1 << 20)
    v1 = c.get(p, lambda: np.zeros(4))
    _touch(p, b"three!!!")  # a size change invalidates even if mtime granularity collides
    v2 = c.get(p, lambda: np.ones(4))
    assert v2 is not v1 and np.all(v2 == 1) and c.misses == 2


def test_lru_eviction_under_budget(tmp_path):
    # the budget fits two 400-byte values; a third evicts the least
    # recently USED (a is touched between b and c, so b goes)
    paths = []
    for name in "abc":
        p = str(tmp_path / f"{name}.bin")
        _touch(p, name.encode())
        paths.append(p)
    c = DeviceFileCache(budget_bytes=lambda dev: 800)
    builds = {p: 0 for p in paths}

    def build_for(p):
        def build():
            builds[p] += 1
            return torch.zeros(100)  # 400 bytes

        return build

    c.get(paths[0], build_for(paths[0]))
    c.get(paths[1], build_for(paths[1]))
    c.get(paths[0], build_for(paths[0]))
    c.get(paths[2], build_for(paths[2]))  # evicts b
    assert c.nbytes <= 800
    c.get(paths[0], build_for(paths[0]))
    assert builds[paths[0]] == 1  # a survived
    c.get(paths[1], build_for(paths[1]))
    assert builds[paths[1]] == 2  # b was evicted and rebuilt


def test_oversized_value_served_but_not_cached(tmp_path):
    p = str(tmp_path / "big.bin")
    _touch(p)
    c = DeviceFileCache(budget_bytes=lambda dev: 10)
    v = c.get(p, lambda: np.zeros(100, np.float32))
    assert v.size == 100
    assert len(c) == 0 and c.nbytes == 0


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        DeviceFileCache().get(str(tmp_path / "nope"), lambda: 1)


def test_cached_checkpoint_is_a_module_and_invalidates(tmp_path):
    ck = str(tmp_path / "classifier_model.ckpt")
    meta = {"model_input_size": 8, "model_hidden_size_fc1": 4, "model_class_count": 2}
    jax_save_checkpoint(ck, "NeuralNetClassifierOnly", meta,
                        jax.device_get(init_classifier(jax.random.PRNGKey(0), 8, 4, 2)))
    name1, meta1, model1 = cached_checkpoint(ck, CPU)
    assert name1 == "NeuralNetClassifierOnly" and meta1["model_class_count"] == 2
    assert isinstance(model1, torch.nn.Module) and not model1.training
    assert all(p.device == CPU and not p.requires_grad for p in model1.parameters())
    assert cached_checkpoint(ck, CPU)[2] is model1  # a hit
    time.sleep(0.01)  # mtime_ns advances even on coarse filesystems
    jax_save_checkpoint(ck, "NeuralNetClassifierOnly", meta,
                        jax.device_get(init_classifier(jax.random.PRNGKey(1), 8, 4, 2)))
    model3 = cached_checkpoint(ck, CPU)[2]
    assert model3 is not model1
    assert not torch.allclose(model1.fc1.weight, model3.fc1.weight)


def test_phase_collector_thread_safety_and_counts():
    with phases.collect() as ph:

        def work():
            for _ in range(50):
                with phases.phase("p"):
                    pass
                phases.count("dispatches")

        ts = [threading.Thread(target=work) for _ in range(4)]
        [t.start() for t in ts]
        [t.join(timeout=30) for t in ts]
        assert not any(t.is_alive() for t in ts)
    assert ph["dispatches"] == 200
    assert ph["p"] >= 0.0
    # inactive collector: zero effect
    with phases.phase("q"):
        pass
    phases.count("q")
    assert "q" not in ph


def test_a_late_phase_writes_to_its_own_collector():
    """Generation safety: a phase that began under one request's collector
    and ends after the next request's began writes to the first."""
    gate, begun = threading.Event(), threading.Event()

    def late():
        with phases.phase("late"):
            begun.set()
            gate.wait(timeout=10)

    with phases.collect() as first:
        t = threading.Thread(target=late)
        t.start()
        assert begun.wait(timeout=10)
    with phases.collect() as second:
        gate.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert "late" in first and "late" not in second


def test_prefetch_iter_failure_directions():
    def producer():
        yield 1
        raise ValueError("bad block")

    it = prefetch_iter(producer())
    assert next(it) == 1
    with pytest.raises(ValueError, match="bad block"):
        next(it)  # the producer's error reaches the consumer

    made = []

    def endless():
        for i in range(10_000):
            made.append(i)
            yield i

    it = prefetch_iter(endless(), depth=2)
    assert next(it) == 0
    it.close()  # the consumer abandons it: the producer stops
    time.sleep(0.5)
    n = len(made)
    time.sleep(0.3)
    assert len(made) == n < 100


def test_read_kf_files_cached_matches_and_invalidates(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(5):
        p = str(tmp_path / f"q{i}.kf")
        write_kf(p, [(f"q{i}", rng.random(16))])
        paths.append(p)
    names_ref, mat_ref = read_kf_files(paths, dtype=np.float32)
    for _ in range(2):  # cold, then warm
        names, mat = read_kf_files_cached(paths, dtype=np.float32)
        assert names == names_ref
        np.testing.assert_array_equal(mat, mat_ref)
    time.sleep(0.01)
    write_kf(paths[2], [("q2", np.ones(16))])
    _, mat3 = read_kf_files_cached(paths, dtype=np.float32)
    assert np.allclose(mat3[2], 1.0)


def test_query_matrix_serving_byte_parity(tmp_path, monkeypatch):
    """classify+query through the device-resident query matrix (default)
    write the bytes of the per-block route (KF2VEC_NO_QUERY_MATRIX=1),
    a multi-row (chunked-style) query file included."""
    from kf2vecfsw_tpu_torch.infer.classify import classify_func
    from kf2vecfsw_tpu_torch.infer.query import query_func

    rng = np.random.default_rng(5)
    v, e, nb = 32, 8, 6
    qdir, mdir = tmp_path / "q", tmp_path / "m"
    qdir.mkdir()
    mdir.mkdir()
    files = []
    for i in range(5):
        files.append(str(qdir / f"q{i}.kf"))
        write_kf(files[-1], [(f"q{i}", rng.random(v))])
    files.append(str(qdir / "multi.kf"))
    write_kf(files[-1], [("multi", rng.random(v)) for _ in range(3)])
    key = jax.random.PRNGKey(0)
    jax_save_checkpoint(str(mdir / "classifier_model.ckpt"), "NeuralNetClassifierOnly",
                        {"model_input_size": v, "model_hidden_size_fc1": 8, "model_class_count": 2},
                        jax.device_get(init_classifier(key, v, 8, 2)))
    for c in (0, 1):
        jax_save_checkpoint(str(mdir / f"model_subtree_{c}.ckpt"), "NeuralNet",
                            {"model_input_size": v, "model_hidden_size_fc1": 8,
                             "model_embedding_size": e},
                            jax.device_get(init_dist_embed(jax.random.PRNGKey(c), v, 8, e)))
        with open(mdir / f"embeddings_subtree_{c}.csv", "w") as f:
            for i in range(nb):
                f.write(f"g{i}\t" + f32_row(rng.normal(size=e).astype(np.float32)))

    outs = {}
    for tag, env in (("cached", None), ("per_block", "1")):
        odir = tmp_path / f"o_{tag}"
        odir.mkdir()
        cache.clear_all()
        if env is None:
            monkeypatch.delenv("KF2VEC_NO_QUERY_MATRIX", raising=False)
        else:
            monkeypatch.setenv("KF2VEC_NO_QUERY_MATRIX", env)
        with phases.collect() as ph:
            classify_func(str(qdir), files, str(mdir), 28, str(odir), device="cpu")
            query_func(str(qdir), files, str(mdir), str(odir), 28, str(odir), device="cpu")
        assert ph["dispatches"] >= 2 and "model_load" in ph and "format" in ph
        outs[tag] = {f: (odir / f).read_bytes() for f in sorted(os.listdir(odir))
                     if f.endswith((".out", ".csv", ".emb"))}
    assert sorted(outs["cached"]) == sorted(outs["per_block"])
    assert any(f.startswith("apples_input") for f in outs["cached"])
    for f in outs["cached"]:
        assert outs["cached"][f] == outs["per_block"][f], f
    cache.clear_all()
