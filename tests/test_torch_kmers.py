"""The port's get_kmers (CPU) writes `.npy` point sets byte-identical to the
JAX package's on a synthetic FASTA + FASTQ directory: at k = 5 and 7 (dense
counting, one kmer_hist call per batch) and at k = 15 (the host sparse
route of both packages), across the batch boundary, with multi-record
files and an all-N file that both skip."""

import os

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.ingest.kmers import get_kmers as jax_get_kmers
from kf2vecfsw_tpu_torch.cli import main
from kf2vecfsw_tpu_torch.ingest.frequencies import MAX_INFLIGHT
from kf2vecfsw_tpu_torch.ingest.kmers import get_kmers

torch.set_num_threads(1)


def _seq(rng, n):
    return rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=n,
                      p=(0.245, 0.255, 0.25, 0.24, 0.01)).astype(np.uint8).tobytes()


@pytest.fixture(scope="module")
def genome_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("genomes")
    rng = np.random.default_rng(21)
    for i in range(MAX_INFLIGHT + 2):  # more files than one kernel batch
        n = int(rng.integers(1_000, 4_000))
        if i % 3 == 0:  # multi-record FASTA, wrapped and lowercase
            s1, s2 = _seq(rng, n).lower(), _seq(rng, n // 3)
            body = b"\n".join(s1[j : j + 60] for j in range(0, len(s1), 60))
            (d / f"g{i:02d}.fna").write_bytes(b">r1\n" + body + b"\n>r2\n" + s2 + b"\n")
        elif i % 3 == 1:  # FASTQ, two reads
            r1, r2 = _seq(rng, n), _seq(rng, 120)
            (d / f"g{i:02d}.fq").write_bytes(
                b"@a\n" + r1 + b"\n+\n" + b"I" * len(r1) + b"\n@b\n" + r2 + b"\n+\n" + b"I" * len(r2) + b"\n")
        else:
            (d / f"g{i:02d}.fa").write_bytes(b">x\n" + _seq(rng, n) + b"\n")
    (d / "all_n.fasta").write_bytes(b">n\n" + b"N" * 300 + b"\n")
    (d / "notes.txt").write_bytes(b"not a sequence file\n")
    return d


@pytest.mark.parametrize("k", [5, 7, 15])
def test_npy_bytes_equal_jax(genome_dir, tmp_path, k):
    ref, port = tmp_path / "jax", tmp_path / "port"
    jax_written = jax_get_kmers(str(genome_dir), str(ref), k=k)
    written = get_kmers(str(genome_dir), str(port), k=k, threads=2, device="cpu")
    assert [os.path.basename(p) for p in written] == [os.path.basename(p) for p in jax_written]
    assert len(written) == MAX_INFLIGHT + 2  # the all-N genome is skipped by both
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    for f in os.listdir(ref):
        assert (port / f).read_bytes() == (ref / f).read_bytes(), f
    m = np.load(port / f"g00_k{k}.npy")
    assert m.dtype == np.float32 and m.shape[1] == k + 1
    assert abs(float(m[:, k].sum()) - 1.0) < 1e-5


def test_cli_get_kmers(genome_dir, tmp_path):
    main(["get_kmers", "-input_dir", str(genome_dir), "-output_dir", str(tmp_path), "-k", "6",
          "-device", "cpu"])
    jax_get_kmers(str(genome_dir), str(tmp_path / "jax"), k=6)
    assert (tmp_path / "g01_k6.npy").read_bytes() == (tmp_path / "jax" / "g01_k6.npy").read_bytes()
