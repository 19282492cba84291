"""The port's get_frequencies (CPU) writes `.kf` files byte-identical to the
JAX package's on a synthetic FASTA + FASTQ directory."""

import os

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.ingest.frequencies import get_frequencies as jax_get_frequencies
from kf2vecfsw_tpu_torch.ingest.frequencies import MAX_INFLIGHT, get_frequencies

torch.set_num_threads(1)


def _seq(rng, n, alphabet=b"ACGTN", p=(0.245, 0.255, 0.25, 0.24, 0.01)):
    return rng.choice(np.frombuffer(alphabet, np.uint8), size=n, p=p).astype(np.uint8).tobytes()


@pytest.fixture(scope="module")
def genome_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("genomes")
    rng = np.random.default_rng(7)
    # more files than one kernel batch, so the batch boundary is crossed
    for i in range(MAX_INFLIGHT + 2):
        n = int(rng.integers(2_000, 12_000))
        if i % 3 == 0:  # multi-record FASTA with wrapped lines and lowercase
            s1, s2 = _seq(rng, n).lower(), _seq(rng, n // 2)
            body = b"\n".join(s1[j : j + 70] for j in range(0, len(s1), 70))
            (d / f"g{i:02d}.fna").write_bytes(b">r1 desc\n" + body + b"\n>r2\n" + s2 + b"\n")
        elif i % 3 == 1:  # FASTQ, two reads
            r1, r2 = _seq(rng, n), _seq(rng, 150)
            (d / f"g{i:02d}.fastq").write_bytes(
                b"@a\n" + r1 + b"\n+\n" + b"I" * len(r1) + b"\n@b\n" + r2 + b"\n+\n" + b"I" * len(r2) + b"\n"
            )
        else:
            (d / f"g{i:02d}.fa").write_bytes(b">x\n" + _seq(rng, n) + b"\n")
    (d / "all_n.fasta").write_bytes(b">n\n" + b"N" * 500 + b"\n")
    (d / "short.fq").write_bytes(b"@s\nACG\n+\nIII\n")
    (d / "notes.txt").write_bytes(b"not a sequence file\n")
    return str(d)


@pytest.mark.parametrize("k", [5, 7])
@pytest.mark.parametrize("pseudocount,raw_cnt", [(False, False), (True, False), (False, True), (True, True)])
def test_kf_bytes_equal_jax(genome_dir, tmp_path, k, pseudocount, raw_cnt):
    out_jax, out_port = tmp_path / "jax", tmp_path / "port"
    out_jax.mkdir()
    out_port.mkdir()
    jax_written = jax_get_frequencies(
        genome_dir, str(out_jax), k=k, threads=2, pseudocount=pseudocount,
        raw_cnt=raw_cnt, backend="numpy",
    )
    written = get_frequencies(
        genome_dir, str(out_port), k=k, threads=2, pseudocount=pseudocount,
        raw_cnt=raw_cnt, device="cpu",
    )
    assert [os.path.basename(p) for p in written] == [os.path.basename(p) for p in jax_written]
    assert len(written) == MAX_INFLIGHT + 4
    for p in jax_written:
        name = os.path.basename(p)
        assert (out_port / name).read_bytes() == (out_jax / name).read_bytes(), name
