"""Secondary/third/fourth-best class post-processor (the port's copy of the
JAX package's ``infer/secondary.py``; reference: get_secondary_classes.py).

Reads a classes.out table and emits classes_{second,third,fourth}Best.out
with top_class/top_p replaced by the n-th best class and its probability.
"""

from __future__ import annotations

import os

import numpy as np

from ..io.kf import float_repr

_NAMES = {2: "classes_secondBest.out", 3: "classes_thirdBest.out", 4: "classes_fourthBest.out"}


def write_secondary_classes(classes_path: str) -> list[str]:
    out_dir = os.path.dirname(classes_path) or "."
    with open(classes_path) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in f if line.strip()]

    i_top = header.index("top_class")
    i_p = header.index("top_p")
    prob_start = i_p + 1
    if not rows:  # header-only classes.out: nothing to rank
        return []
    probs = np.array([[float(v) for v in r[prob_start:]] for r in rows])
    order = np.argsort(-probs, axis=1)

    written = []
    for rank, fname in _NAMES.items():
        if probs.shape[1] < rank:
            continue
        path = os.path.join(out_dir, fname)
        with open(path, "w") as f:
            f.write("\t".join(header) + "\n")
            for i, r in enumerate(rows):
                cls = int(order[i, rank - 1])
                r2 = list(r)
                r2[i_top] = float_repr(float(cls))
                r2[i_p] = float_repr(float(probs[i, cls]))
                f.write("\t".join(r2) + "\n")
        written.append(path)
    return written
