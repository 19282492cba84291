"""Host-side sequence ingest: FASTA/FASTQ parsing and base encoding.

The port's own copy of the JAX package's ``kf2vecfsw_tpu/io/fasta.py``: a
byte-level pass over the raw file, then the port's C++ text library
(``io/native``) encodes bases to uint8 codes A=0, C=1, G=2, T=3
(case-insensitive), INVALID=4 for anything else. ``encode_bases_plain``, a
256-entry numpy lookup table, gives the same bytes.
"""

from __future__ import annotations

import fnmatch
import os
from dataclasses import dataclass

import numpy as np

from .native.lib import load as load_textio

INVALID = 4

# Matches the reference's accepted input formats (main.py:272).
SEQUENCE_EXTENSIONS = (".fq", ".fastq", ".fa", ".fna", ".fasta")

# byte -> base code lookup (A/a=0, C/c=1, G/g=2, T/t=3, rest INVALID)
_ENCODE_LUT = np.full(256, INVALID, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ENCODE_LUT[_b] = _i
    _ENCODE_LUT[_b + 32] = _i  # lowercase


@dataclass
class SeqRecord:
    name: str  # first whitespace-delimited token of the header
    codes: np.ndarray  # uint8 base codes


def encode_bases(seq: bytes | np.ndarray) -> np.ndarray:
    """Encode sequence bytes to uint8 base codes (0..3, INVALID=4)."""
    return load_textio().encode(seq)


def encode_bases_plain(seq: bytes | np.ndarray) -> np.ndarray:
    """``encode_bases`` with a numpy lookup table."""
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
    return _ENCODE_LUT[arr]


def _parse_fasta(data: bytes) -> list[tuple[str, bytes]]:
    records: list[tuple[str, bytes]] = []
    pos = 0
    n = len(data)
    while pos < n:
        if data[pos] != 0x3E:  # '>'
            pos = data.find(b"\n", pos)
            if pos < 0:
                break
            pos += 1
            continue
        eol = data.find(b"\n", pos)
        if eol < 0:
            eol = n
        header = data[pos + 1 : eol].split()
        name = header[0].decode() if header else ""
        nxt = data.find(b">", eol)
        if nxt < 0:
            nxt = n
        seq = data[eol + 1 : nxt].replace(b"\n", b"").replace(b"\r", b"")
        records.append((name, seq))
        pos = nxt
    return records


def _parse_fastq(data: bytes) -> list[tuple[str, bytes]]:
    records: list[tuple[str, bytes]] = []
    lines = data.split(b"\n")
    i = 0
    n = len(lines)
    while i + 1 < n:
        header = lines[i]
        if not header.startswith(b"@"):
            i += 1
            continue
        tokens = header[1:].split()
        name = tokens[0].decode() if tokens else ""
        seq = lines[i + 1].rstrip(b"\r")
        records.append((name, seq))
        i += 4  # header, seq, '+', quals
    return records


def read_sequences_raw(path: str) -> list[tuple[str, bytes]]:
    """Read all (name, raw sequence bytes) records from a FASTA/FASTQ file."""
    with open(path, "rb") as f:
        data = f.read()
    if data.lstrip()[:1] == b"@":
        return _parse_fastq(data)
    return _parse_fasta(data)


def read_sequences(path: str) -> list[SeqRecord]:
    """Read all records from a FASTA or FASTQ file, encoded to base codes."""
    return [SeqRecord(name, encode_bases(seq)) for name, seq in read_sequences_raw(path)]


def remove_gaps(seq: bytes) -> bytes:
    """Remove gap characters like ``seqkit seq -g`` (default gap letters '- .')."""
    return seq.replace(b"-", b"").replace(b".", b"").replace(b" ", b"")


def list_sequence_files(input_dir: str) -> list[str]:
    """List input sequence files exactly like the reference (main.py:272-275)."""
    return [
        f
        for f in sorted(os.listdir(input_dir))
        if any(fnmatch.fnmatch(f, "*" + ext) for ext in SEQUENCE_EXTENSIONS)
    ]


def sample_name(filename: str) -> str:
    """Sample name = filename up to the last '.f' (main.py:275 rsplit('.f', 1))."""
    return os.path.basename(filename).rsplit(".f", 1)[0]
