"""ctypes loader of the port's host text library (``textio.cpp``).

The library is built at first use with g++ into ``build/libtextio-<hash>.so``
beside this file (``build/`` is git-ignored; the hash covers the source and
the flags, so an edited source never meets a stale library). It is written
to a temporary file and moved into place, so processes that build at once
never load a partial file. A failed build raises with g++'s output, and
nothing switches the library off: every caller of the port's text I/O runs
it.

``TextIO`` has one method per entry point, with the signatures of the JAX
package's loader (``kf2vecfsw_tpu/io/native/lib.py``); the parsers return
None for input they refuse (malformed or ragged text), which the callers
then parse in Python, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "textio.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_f32p = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libtextio-{digest}.so"


def build() -> Path:
    """The built library, compiling it if it is not there yet."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"building {SOURCE.name} needs g++: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{SOURCE.name} build failed (g++ exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out


class TextIO:
    def __init__(self, cdll: ctypes.CDLL):
        self._c = cdll
        c = cdll
        c.kf2vec_encode.argtypes = [_u8p, ctypes.c_int64, _u8p]
        c.kf2vec_encode.restype = None
        c.kf2vec_format_counts.argtypes = [_i64p, ctypes.c_int64, _u8p]
        c.kf2vec_format_counts.restype = ctypes.c_int64
        c.kf2vec_format_doubles.argtypes = [_f64p, ctypes.c_int64, _u8p, ctypes.c_char]
        c.kf2vec_format_doubles.restype = ctypes.c_int64
        c.kf2vec_format_floats.argtypes = [_f32p, ctypes.c_int64, _u8p, ctypes.c_char]
        c.kf2vec_format_floats.restype = ctypes.c_int64
        c.kf2vec_parse_doubles.argtypes = [ctypes.c_char_p, ctypes.c_int64, _f64p, ctypes.c_int64]
        c.kf2vec_parse_doubles.restype = ctypes.c_int64
        c.kf2vec_parse_table.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, _f64p, ctypes.c_int64, _i64p, ctypes.c_int64, _i64p,
        ]
        c.kf2vec_parse_table.restype = ctypes.c_int64

    @staticmethod
    def _ptr(arr: np.ndarray, ptype):
        return arr.ctypes.data_as(ptype)

    def encode(self, seq: bytes | np.ndarray) -> np.ndarray:
        """Sequence bytes -> uint8 base codes (A/a=0, C/c=1, G/g=2, T/t=3,
        anything else 4)."""
        if isinstance(seq, (bytes, bytearray)):
            src = np.frombuffer(seq, dtype=np.uint8)
        else:
            src = np.ascontiguousarray(seq, dtype=np.uint8)
        out = np.empty(src.size, dtype=np.uint8)
        self._c.kf2vec_encode(self._ptr(src, _u8p), src.size, self._ptr(out, _u8p))
        return out

    def parse_doubles(self, text: bytes, expect: int | None = None) -> np.ndarray | None:
        """A ',' / tab / space separated run of floats; None if malformed
        (or not ``expect`` values long)."""
        cap = expect if expect is not None else max(8, len(text) // 2 + 2)
        out = np.empty(cap, dtype=np.float64)
        n = self._c.kf2vec_parse_doubles(text, len(text), self._ptr(out, _f64p), cap)
        if n < 0 or (expect is not None and n != expect):
            return None
        return out[:n]

    def parse_table(self, data: bytes) -> tuple[list[str], np.ndarray] | None:
        """A whole name-prefixed numeric table (`.kf` rows, a `.di_mtrx`
        body) -> (names, (rows, cols) float64); None if malformed or
        ragged."""
        n = len(data)
        max_rows = data.count(b"\n") + 2
        vals = np.empty(max(8, n // 2 + 2), dtype=np.float64)
        spans = np.empty(2 * max_rows, dtype=np.int64)
        cols = np.zeros(1, dtype=np.int64)
        rows = self._c.kf2vec_parse_table(
            data, n, self._ptr(vals, _f64p), vals.size, self._ptr(spans, _i64p), max_rows,
            self._ptr(cols, _i64p),
        )
        if rows < 0:
            return None
        c = int(cols[0])
        names = [data[spans[2 * i] : spans[2 * i + 1]].decode() for i in range(rows)]
        return names, vals[: rows * c].reshape(rows, c).copy()

    def format_doubles(self, vals: np.ndarray, sep: str = ",") -> str:
        """repr(float) of each float64 value, joined by ``sep``, then '\\n'."""
        vals = np.ascontiguousarray(vals, dtype=np.float64)
        out = np.empty(max(1, vals.size * 26), dtype=np.uint8)
        n = self._c.kf2vec_format_doubles(
            self._ptr(vals, _f64p), vals.size, self._ptr(out, _u8p), sep.encode())
        return out[:n].tobytes().decode("ascii")

    def format_floats(self, vals: np.ndarray, sep: str = "\t") -> str:
        """str(np.float32) of each float32 value, joined by ``sep``, then '\\n'."""
        vals = np.ascontiguousarray(vals, dtype=np.float32)
        out = np.empty(max(1, vals.size * 22), dtype=np.uint8)
        n = self._c.kf2vec_format_floats(
            self._ptr(vals, _f32p), vals.size, self._ptr(out, _u8p), sep.encode())
        return out[:n].tobytes().decode("ascii")

    def format_counts(self, vals: np.ndarray) -> str:
        """An int64 vector as 'v.0,v.0,...,v.0\\n' (the `.kf` row tail of
        integral counts)."""
        vals = np.ascontiguousarray(vals, dtype=np.int64)
        out = np.empty(max(1, vals.size * 24), dtype=np.uint8)
        n = self._c.kf2vec_format_counts(self._ptr(vals, _i64p), vals.size, self._ptr(out, _u8p))
        return out[:n].tobytes().decode("ascii")


@functools.cache
def load() -> TextIO:
    """The library, built on first use; raises if it cannot be built."""
    return TextIO(ctypes.CDLL(str(build())))
