"""Patristic leaf-to-leaf distance matrices (the port's copy of the JAX
package's ``tree/distance.py``, with its pure-Python formatting and parsing
branches; the JAX package's C++ formatter writes the same bytes).

Replaces treeswift's ``tree.distance_matrix(leaf_labels=True)``
(main.py:469,500). Computed in O(n^2) with numpy block fills via postorder
LCA accumulation: at each internal node, every pair of leaves in different
child subtrees has that node as LCA, so their distance is the sum of their
depths below the node.
"""

from __future__ import annotations

import numpy as np

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
    with open(path, "w") as f:
        f.write("\t" + "\t".join(labels) + "\n")
        for lbl, row in zip(labels, np.asarray(dist, dtype=np.float64).tolist()):
            f.write(lbl + "\t" + "\t".join(map(repr, row)) + "\n")


def read_di_mtrx(path: str) -> tuple[list[str], list[str], np.ndarray]:
    """Read a .di_mtrx -> (row labels, col labels, values). Row/col orders may
    differ (the reference's treeswift dict ordering is traversal-dependent);
    consumers must reindex by label (utils sort_df equivalent)."""
    with open(path) as f:
        col_labels = f.readline().rstrip("\n").rstrip("\r").split("\t")[1:]
        row_labels: list[str] = []
        rows: list[np.ndarray] = []
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
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
