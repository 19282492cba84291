"""The port's ``get_chunks`` against the JAX package's, on the CPU (the port
with ``-device cpu``, counting through the plain version of ``kmer_hist``).

Everything here is exact: window spans, cleaned contigs, row names and
counts, and the `.kf` bytes, on synthetic genomes of 50-120 kb at k=3 with
10 kb windows: N runs, '-', '.' and space gaps, lowercase, short contigs,
a contig of exactly one window, FASTA and FASTQ, a genome of fewer than 5
windows and one with no contig of 10 kb."""

import os
import re

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.cli import main as jax_main
from kf2vecfsw_tpu.ingest import chunks as jax_chunks
from kf2vecfsw_tpu_torch.cli import main
from kf2vecfsw_tpu_torch.ingest import chunks
from kf2vecfsw_tpu_torch.kmer.counter import KmerCounter

torch.set_num_threads(1)

K, W = 3, 10_000


def _seq(rng, n, alphabet=b"ACGT"):
    return rng.choice(np.frombuffer(alphabet, np.uint8), size=n).tobytes()


def _gappy(rng, n):
    """n random bases with N runs (some with '|'), '-', '.' and space gaps and
    a lowercase stretch."""
    seq = bytearray(_seq(rng, n))
    for start in rng.integers(0, n - 50, size=8):
        run = int(rng.integers(1, 40))
        seq[start : start + run] = bytes(rng.choice(np.frombuffer(b"NNn|", np.uint8), size=run))
    for start in rng.integers(0, n - 5, size=12):
        seq[start] = b"-. "[int(rng.integers(0, 3))]
    lo = int(rng.integers(0, n - 500))
    seq[lo : lo + 400] = bytes(seq[lo : lo + 400]).lower()
    return bytes(seq)


def _records(rng):
    """Contigs of 61 kb (gappy), 8 kb (dropped), exactly one window, one
    window and a base, and 27 kb."""
    return [("c1", _gappy(rng, 61_000)), ("short", _seq(rng, 8_000)), ("one", _seq(rng, W)),
            ("one_plus", _seq(rng, W + 1)), ("c5", _gappy(rng, 27_000))]


def test_window_spans_and_clean_contig_equal_jax():
    for length in (9_999, 10_000, 10_001, 19_999, 20_000, 25_000, 50_003, 100_003, 120_000):
        assert chunks.window_spans(length, W) == jax_chunks.window_spans(length, W)
    rng = np.random.default_rng(1)
    for seq in (b"ACGTNNNNNACGT", b"AC-G.T nn|NN", b"N|n-N.A", _gappy(rng, 3_000)):
        assert chunks.clean_contig(seq) == jax_chunks.clean_contig(seq)


@pytest.mark.parametrize("pseudocount", [False, True])
def test_chunk_rows_for_genome_equal_jax(pseudocount):
    records = _records(np.random.default_rng(2))
    got = chunks.chunk_rows_for_genome("g", records, KmerCounter(K, device="cpu"), W, pseudocount)
    ref = jax_chunks.chunk_rows_for_genome("g", records, K, W, pseudocount)
    assert [n for n, _ in got] == [n for n, _ in ref]
    assert len(got) == 7 + 3 + 1 + 2  # c1, c5 (3 windows), one, one_plus
    assert "g.part_one.part_one_sliding__1-10000" in [n for n, _ in got]
    for (_, a), (_, b) in zip(got, ref):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)


def _fasta_dir(root):
    """Five genomes: two of 50-120 kb in contigs, one as FASTQ, one of four
    windows (dropped: fewer than 5) and one whose contigs are all under 10 kb
    (dropped: none above the threshold)."""
    rng = np.random.default_rng(3)
    fna = root / "fna"
    fna.mkdir()
    (fna / "gA.fna").write_bytes(b"".join(b">%s desc\n%s\n" % (n.encode(), s)
                                          for n, s in _records(rng)))
    body = _gappy(rng, 50_000)
    (fna / "gB.fa").write_bytes(b">b1\n" + b"\n".join(body[i : i + 80]
                                                      for i in range(0, len(body), 80)) + b"\n")
    read = _seq(rng, 120_000)
    (fna / "gC.fastq").write_bytes(b"@r1 x\n%s\n+\n%s\n" % (read, b"I" * len(read)))
    (fna / "gD.fna").write_bytes(b">d1\n%s\n" % _seq(rng, 35_000))
    (fna / "gE.fasta").write_bytes(b"".join(b">e%d\n%s\n" % (i, _seq(rng, 9_000)) for i in range(4)))
    return str(fna)


def _log_lines(out):
    [path] = [p for p in os.listdir(out) if p.startswith("get_chunks_")]
    with open(os.path.join(out, path)) as f:
        return [re.sub(r" Time: \d\d:\d\d:\d\d$", "", line.rstrip("\n")) for line in f]


@pytest.mark.parametrize("pseudocount", [False, True])
def test_get_chunks_bytes_equal_jax(tmp_path, pseudocount):
    fna = _fasta_dir(tmp_path)
    flags = ["-pseudocount"] if pseudocount else []
    for tag, run, extra in (("jax", jax_main, []), ("port", main, ["-device", "cpu"])):
        (tmp_path / tag).mkdir()
        run(["get_chunks", "-input_dir", fna, "-output_dir", str(tmp_path / tag), "-k", str(K),
             "-p", "2", *flags, *extra])
    kf = sorted(p.name for p in (tmp_path / "port").glob("*.kf"))
    assert kf == sorted(p.name for p in (tmp_path / "jax").glob("*.kf")) == [
        "gA.kf", "gB.kf", "gC.kf"]
    for name in kf:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    lines = _log_lines(tmp_path / "port")
    assert lines == _log_lines(tmp_path / "jax")
    assert "==> Excluded gD.fna. 4 chunks is too low. 5 is required." in lines
    assert "==> Excluded gE.fasta. No contigs above threshold length." in lines


def test_windows_per_launch_budget_splits_a_genome(tmp_path, monkeypatch):
    """A device memory small enough for 2 windows a launch: a genome's n
    windows go in ceil(n / 2) count_batch calls and the bytes do not change."""
    fna = _fasta_dir(tmp_path)
    whole, split = tmp_path / "whole", tmp_path / "split"
    whole.mkdir()
    split.mkdir()
    chunks.get_chunks(fna, str(whole), k=K, device="cpu")
    per_window = 4 * (4**K + 32) + 48 * W
    monkeypatch.setenv("KF2VEC_HBM_BYTES", str(16 * 2 * per_window + 15))
    assert chunks.windows_per_launch(K, W, "cpu") == 2
    calls = []
    real = KmerCounter.count_batch
    monkeypatch.setattr(KmerCounter, "count_batch",
                        lambda self, batch: calls.append(len(batch)) or real(self, batch))
    chunks.get_chunks(fna, str(split), k=K, device="cpu")
    rows = [len((whole / f"g{g}.kf").read_text().splitlines()) for g in "ABC"]
    assert rows == [13, 5, 12]
    assert calls == [c for n in rows for c in [2] * (n // 2) + [1] * (n % 2)]
    for p in whole.glob("*.kf"):
        assert (split / p.name).read_bytes() == p.read_bytes()
    monkeypatch.setenv("KF2VEC_HBM_BYTES", "1")
    assert chunks.windows_per_launch(13, W, "cpu") == 1


def test_get_chunks_refuses_k_above_13_as_jax_does(tmp_path):
    fna = _fasta_dir(tmp_path)
    for fn, extra in ((jax_chunks.get_chunks, {}), (chunks.get_chunks, {"device": "cpu"})):
        with pytest.raises(ValueError, match=r"dense canonical vocab supports 1 <= k <= 13, got 14"):
            fn(fna, str(tmp_path), k=14, **extra)
