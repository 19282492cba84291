"""Tree CLI operations: divide_tree, get_distances, scale_tree (the port's
copy of the JAX package's ``ingest/tree_ops.py``; host only).

Outputs are written next to the ``-tree`` input, as the reference does. In-repo
replacements for the reference handlers at main.py:186-247 (TreeCluster
subprocess), main.py:440-502 (treeswift distance matrices) and main.py:414-436.
"""

from __future__ import annotations

import os
import sys
import warnings

from ..tree.cluster import assign_clades, sum_branch_clusters
from ..tree.distance import leaf_distance_matrix, write_di_mtrx
from ..tree.newick import Tree, read_tree_newick


def _load_tree(tree_path: str) -> Tree:
    try:
        return read_tree_newick(tree_path)
    except OSError:
        print(f"No such file '{tree_path}'", file=sys.stderr)
        raise SystemExit(1)


def divide_tree(tree_path: str, size: int, single_cut: bool = False) -> str:
    """Split the phylogeny into subtrees; writes {tree}.subtrees next to the
    input (main.py:186-247). Returns the output path. ``single_cut`` mirrors
    upstream TreeCluster's one-cut-per-node ambiguity resolution (see
    tree/cluster.py docstring)."""
    tree = _load_tree(tree_path)
    head = os.path.split(tree_path)[0]
    tree_name = os.path.splitext(os.path.basename(tree_path))[0]

    # unit-length pre-pass on labeled nodes (main.py:203-205)
    for node in tree.traverse_postorder():
        if node.label is not None:
            node.edge_length = 1.0

    stats: dict = {}
    clusters = sum_branch_clusters(tree, 2 * size, single_cut=single_cut, stats=stats)
    if stats.get("ambiguous_nodes", 0) > 0:
        warnings.warn(
            f"sum_branch hit the both-children-over-threshold case at "
            f"{stats['ambiguous_nodes']} node(s); the partition depends on the "
            "ambiguity mode (default: cut-until-under; -tc_single_cut mirrors "
            "upstream TreeCluster) and may differ from a reference-built library."
        )
    n_singletons = sum(1 for c in clusters if len(c) == 1)
    if n_singletons > 0:
        warnings.warn(
            f"{n_singletons} samples are assigned to subtrees -1 and will be "
            "excluded.\nPlease check rooting of your phylogeny or increase "
            "subtree size."
        )
    else:
        print("There are no -1 subtrees. Keep going...")

    out_path = os.path.join(head, f"{tree_name}.subtrees")
    with open(out_path, "w") as f:
        f.write("genome clade\n")
        for genome, clade in assign_clades(clusters):
            f.write(f"{genome} {clade}\n")
    return out_path


def read_subtrees(path: str) -> list[tuple[str, int]]:
    """Read a .subtrees file -> [(genome, clade)] preserving row order."""
    out: list[tuple[str, int]] = []
    with open(path) as f:
        header = f.readline()
        del header
        for line in f:
            line = line.strip()
            if not line:
                continue
            genome, clade = line.split()
            out.append((genome, int(clade)))
    return out


def get_distances(tree_path: str, subtrees: str | None, mode: str = "subtrees_only") -> list[str]:
    """Write per-subtree (and/or full) .di_mtrx files (main.py:440-502)."""
    if mode not in ("hybrid", "full_only", "subtrees_only"):
        raise SystemExit(
            f"unknown -mode '{mode}' (choose hybrid, full_only or subtrees_only)"
        )
    tree = _load_tree(tree_path)
    head = os.path.split(tree_path)[0]
    tree_name = os.path.splitext(os.path.basename(tree_path))[0]
    written: list[str] = []

    if mode in ("full_only", "hybrid"):
        n_leaves = tree.num_nodes(internal=False)
        if n_leaves > 12000:
            warnings.warn(
                f"Phylogeny contains {n_leaves} samples which is above recommended "
                "threshold of 12000 species.\nComputation of distance matrix might "
                "take long time."
            )
        labels, dist = leaf_distance_matrix(tree)
        out = os.path.join(head, f"{tree_name}_full.di_mtrx")
        write_di_mtrx(out, labels, dist)
        written.append(out)

    if mode in ("hybrid", "subtrees_only"):
        if subtrees is None:
            print(
                f"No such file '{subtrees}'. Please provide /.subtrees file or "
                "change mode to full_only",
                file=sys.stderr,
            )
            raise SystemExit(1)
        rows = read_subtrees(subtrees)
        clades = sorted({c for _, c in rows})
        for c in clades:
            labels_to_keep = {g for g, cl in rows if cl == c}
            sub = tree.extract_tree_with(labels_to_keep)
            labels, dist = leaf_distance_matrix(sub)
            out = os.path.join(head, f"{tree_name}_subtree_{c}.di_mtrx")
            write_di_mtrx(out, labels, dist)
            written.append(out)
    return written


def scale_tree(tree_path: str, factor: float) -> str:
    """Scale all edges, write {name}_r{factor}{ext} (main.py:414-436)."""
    tree = _load_tree(tree_path)
    head = os.path.split(tree_path)[0]
    filename, ext = os.path.splitext(os.path.basename(tree_path))
    print(f"Original diameter: {tree.diameter()}")
    tree.scale_edges(factor)
    print(f"Scaled diameter: {tree.diameter()}")
    out = os.path.join(head, f"{filename}_r{factor}{ext}")
    tree.write_tree_newick(out)
    return out
