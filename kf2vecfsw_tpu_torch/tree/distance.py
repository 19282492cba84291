"""Patristic leaf-to-leaf distance matrices (the port's copy of the JAX
package's ``tree/distance.py``). `.di_mtrx` rows are formatted and parsed by
the port's C++ text library (``io/native``); ``write_di_mtrx_plain`` and
``read_di_mtrx_plain`` write and read the same bytes and values in Python.

Replaces treeswift's ``tree.distance_matrix(leaf_labels=True)``
(main.py:469,500). Computed in O(n^2) with numpy block fills via postorder
LCA accumulation: at each internal node, every pair of leaves in different
child subtrees has that node as LCA, so their distance is the sum of their
depths below the node.
"""

from __future__ import annotations

import numpy as np

from ..io.native.lib import load as load_textio
from .newick import Tree


def leaf_distance_matrix(tree: Tree) -> tuple[list[str], np.ndarray]:
    """Returns (leaf labels in postorder-appearance order, dense symmetric
    float64 distance matrix with 0 diagonal)."""
    leaves = tree.leaves()
    labels = [n.label for n in leaves]
    n_leaves = len(leaves)
    idx = {id(n): i for i, n in enumerate(leaves)}
    dist = np.zeros((n_leaves, n_leaves), dtype=np.float64)

    # per-node: (leaf index array, depth-below-node array)
    acc: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    for node in tree.traverse_postorder():
        if node.is_leaf():
            acc[id(node)] = (
                np.array([idx[id(node)]], dtype=np.int64),
                np.zeros(1, dtype=np.float64),
            )
            continue
        groups = []
        for c in node.children:
            ix, depth = acc.pop(id(c))
            groups.append((ix, depth + (c.edge_length or 0.0)))
        for a in range(len(groups)):
            ia, da = groups[a]
            for b in range(a + 1, len(groups)):
                ib, db = groups[b]
                block = da[:, None] + db[None, :]
                dist[np.ix_(ia, ib)] = block
                dist[np.ix_(ib, ia)] = block.T
        acc[id(node)] = (
            np.concatenate([g[0] for g in groups]),
            np.concatenate([g[1] for g in groups]),
        )
    return labels, dist


def write_di_mtrx(path: str, labels: list[str], dist: np.ndarray) -> None:
    """Write a tab-separated .di_mtrx with header and index column, matching
    the reference's pandas to_csv format (main.py:471,502): float64 values
    in Python repr."""
    textio = load_textio()
    with open(path, "w") as f:
        f.write("\t" + "\t".join(labels) + "\n")
        for i, lbl in enumerate(labels):
            f.write(lbl + "\t" + textio.format_doubles(np.asarray(dist[i], dtype=np.float64), sep="\t"))


def write_di_mtrx_plain(path: str, labels: list[str], dist: np.ndarray) -> None:
    """``write_di_mtrx`` in pure Python."""
    with open(path, "w") as f:
        f.write("\t" + "\t".join(labels) + "\n")
        for lbl, row in zip(labels, np.asarray(dist, dtype=np.float64).tolist()):
            f.write(lbl + "\t" + "\t".join(map(repr, row)) + "\n")


def read_di_mtrx(path: str) -> tuple[list[str], list[str], np.ndarray]:
    """Read a .di_mtrx -> (row labels, col labels, values). Row/col orders may
    differ (the reference's treeswift dict ordering is traversal-dependent);
    consumers must reindex by label (utils sort_df equivalent). The body is
    parsed as one table; row by row in Python if the parser refuses it or
    its width is not the header's, as in the JAX package."""
    with open(path, "rb") as fb:
        data = fb.read()
    head_end = data.find(b"\n")
    header = data[: max(head_end, 0)].decode().rstrip("\r").split("\t")
    col_labels = header[1:]
    body = data[head_end + 1 :] if head_end >= 0 else b""
    res = load_textio().parse_table(body)
    if res is not None and res[1].shape[1] == len(col_labels):
        return res[0], col_labels, res[1]
    return _read_body_plain(body, col_labels)


def read_di_mtrx_plain(path: str) -> tuple[list[str], list[str], np.ndarray]:
    """``read_di_mtrx`` in pure Python."""
    with open(path, "rb") as fb:
        data = fb.read()
    head_end = data.find(b"\n")
    header = data[: max(head_end, 0)].decode().rstrip("\r").split("\t")
    return _read_body_plain(data[head_end + 1 :] if head_end >= 0 else b"", header[1:])


def _read_body_plain(body: bytes, col_labels: list[str]) -> tuple[list[str], list[str], np.ndarray]:
    row_labels: list[str] = []
    rows: list[np.ndarray] = []
    for line in body.decode().split("\n"):
        line = line.rstrip("\r")
        if not line:
            continue
        name, _, rest = line.partition("\t")
        row_labels.append(name)
        rows.append(np.array(rest.split("\t"), dtype=np.float64))
    return row_labels, col_labels, np.vstack(rows)


def reindex_matrix(
    row_labels: list[str], col_labels: list[str], values: np.ndarray, order: list[str]
) -> np.ndarray:
    """Reorder a labeled matrix to `order` x `order` (sort_df equivalent,
    utils.py:141-192)."""
    rmap = {l: i for i, l in enumerate(row_labels)}
    cmap = {l: i for i, l in enumerate(col_labels)}
    ri = np.array([rmap[l] for l in order], dtype=np.int64)
    ci = np.array([cmap[l] for l in order], dtype=np.int64)
    return values[np.ix_(ri, ci)]
