""".kf feature-file reader/writer, byte-compatible with the JAX package.

A `.kf` file holds one CSV line per sample: ``name,v1,...,vV`` where V is the
canonical vocab size and values are float64 rendered with Python float repr
(the reference builds them via pandas ``astype(str)`` + ``",".join`` at
main.py:344-357). These are the pure-Python branches of
``kf2vecfsw_tpu/io/kf.py``; its C++ formatter writes the same bytes.
"""

from __future__ import annotations

import numpy as np


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


def append_kf(f, name: str, values: np.ndarray) -> None:
    f.write(name)
    f.write(",")
    values = np.asarray(values, dtype=np.float64)
    # integral rows (raw counts): repr of an integral float64 below 1e16 is
    # always "<int>.0", and str(int) is ~10x cheaper than repr(float)
    if values.size and np.abs(values).max() < 1e15 and not np.any(values % 1.0):
        f.write(".0,".join(map(str, values.astype(np.int64).tolist())))
        f.write(".0\n")
    else:
        f.write(",".join(map(repr, values.tolist())))
        f.write("\n")


def read_kf(path: str, dtype=np.float64) -> tuple[list[str], np.ndarray]:
    """Read a .kf file -> (names, (rows, V) float array)."""
    names: list[str] = []
    rows: list[np.ndarray] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            name, _, rest = line.partition(",")
            names.append(name)
            rows.append(np.array(rest.split(","), dtype=np.float64))
    if not rows:
        return names, np.zeros((0, 0), dtype=dtype)
    return names, np.vstack(rows).astype(dtype, copy=False)


def read_kf_files(paths: list[str], dtype=np.float64) -> tuple[list[str], np.ndarray]:
    """Concatenate several .kf files (order preserved)."""
    all_names: list[str] = []
    mats: list[np.ndarray] = []
    for p in paths:
        names, mat = read_kf(p, dtype=dtype)
        all_names.extend(names)
        if mat.size:
            mats.append(mat)
    if not mats:
        return all_names, np.zeros((0, 0), dtype=dtype)
    return all_names, np.vstack(mats)
