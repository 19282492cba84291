""".kf feature-file reader/writer, byte-compatible with the JAX package.

A `.kf` file holds one CSV line per sample: ``name,v1,...,vV`` where V is the
canonical vocab size and values are float64 rendered with Python float repr
(the reference builds them via pandas ``astype(str)`` + ``",".join`` at
main.py:344-357). Chunked `.kf` files hold one line per 10 kb window.

Rows are formatted and whole files parsed by the port's C++ text library
(``io/native``), as the JAX package's ``io/kf.py`` does with its own. A file
the table parser refuses (ragged or malformed) is parsed row by row, as in
the JAX package, so the result or the error is the JAX package's. The
pure-Python functions (``*_plain``) write and read the same bytes and
values; the tests hold the two against each other.
"""

from __future__ import annotations

import numpy as np

from .native.lib import load as load_textio


def float_repr(v: float) -> str:
    """Shortest-repr rendering of a float64, matching str(float) used by the
    reference's pandas astype(str) (main.py:344)."""
    return repr(float(v))


def write_kf(path: str, rows: list[tuple[str, np.ndarray]]) -> None:
    """Write (name, values) rows. Values must already be float64 counts or
    frequencies; formatting matches main.py:344-357 byte for byte."""
    with open(path, "w") as f:
        for name, values in rows:
            append_kf(f, name, values)


def _integral(values: np.ndarray) -> bool:
    # repr of an integral float64 below 1e16 is always "<int>.0"
    return bool(values.size) and np.abs(values).max() < 1e15 and not np.any(values % 1.0)


def append_kf(f, name: str, values: np.ndarray) -> None:
    values = np.asarray(values, dtype=np.float64)
    textio = load_textio()
    if _integral(values):  # raw counts
        line = textio.format_counts(values.astype(np.int64))
    else:
        line = textio.format_doubles(values, sep=",")
    f.write(name + "," + line)


def append_kf_plain(f, name: str, values: np.ndarray) -> None:
    """``append_kf`` in pure Python."""
    f.write(name)
    f.write(",")
    values = np.asarray(values, dtype=np.float64)
    if _integral(values):  # str(int) is ~10x cheaper than repr(float)
        f.write(".0,".join(map(str, values.astype(np.int64).tolist())))
        f.write(".0\n")
    else:
        f.write(",".join(map(repr, values.tolist())))
        f.write("\n")


def _table(data: bytes, dtype) -> tuple[list[str], np.ndarray] | None:
    res = load_textio().parse_table(data)
    if res is None:
        return None
    names, mat = res
    if not names:
        return names, np.zeros((0, 0), dtype=dtype)
    return names, mat.astype(dtype, copy=False)


def _rows(path: str, parse_values, dtype) -> tuple[list[str], np.ndarray]:
    names: list[str] = []
    rows: list[np.ndarray] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            name, _, rest = line.partition(",")
            names.append(name)
            rows.append(parse_values(rest))
    if not rows:
        return names, np.zeros((0, 0), dtype=dtype)
    return names, np.vstack(rows).astype(dtype, copy=False)


def _parse_values_plain(rest: str) -> np.ndarray:
    return np.array(rest.split(","), dtype=np.float64)


def _parse_values(rest: str) -> np.ndarray:
    out = load_textio().parse_doubles(rest.encode("ascii", "replace"))
    return out if out is not None else _parse_values_plain(rest)


def read_kf(path: str, dtype=np.float64) -> tuple[list[str], np.ndarray]:
    """Read a .kf file -> (names, (rows, V) float array)."""
    with open(path, "rb") as fb:
        res = _table(fb.read(), dtype)
    return res if res is not None else _rows(path, _parse_values, dtype)


def read_kf_plain(path: str, dtype=np.float64) -> tuple[list[str], np.ndarray]:
    """``read_kf`` in pure Python."""
    return _rows(path, _parse_values_plain, dtype)


def read_kf_files(paths: list[str], dtype=np.float64) -> tuple[list[str], np.ndarray]:
    """Concatenate several .kf files (order preserved), parsed as one table
    (per-file overhead dominates blocks of many one-row query files); file
    by file if the joined table is refused."""
    if paths:
        parts = []
        for p in paths:
            with open(p, "rb") as fb:
                data = fb.read()
            parts.append(data if not data or data.endswith(b"\n") else data + b"\n")
        res = _table(b"".join(parts), dtype)
        if res is not None:
            return res
    return _concat([read_kf(p, dtype=dtype) for p in paths], dtype)


def read_kf_files_plain(paths: list[str], dtype=np.float64) -> tuple[list[str], np.ndarray]:
    """``read_kf_files`` in pure Python."""
    return _concat([read_kf_plain(p, dtype=dtype) for p in paths], dtype)


def _concat(parts: list[tuple[list[str], np.ndarray]], dtype) -> tuple[list[str], np.ndarray]:
    all_names: list[str] = []
    mats: list[np.ndarray] = []
    for names, mat in parts:
        all_names.extend(names)
        if mat.size:
            mats.append(mat)
    if not mats:
        return all_names, np.zeros((0, 0), dtype=dtype)
    return all_names, np.vstack(mats)
