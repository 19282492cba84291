"""sum_branch tree clustering (in-repo TreeCluster replacement; the port's
copy of the JAX package's ``tree/cluster.py``).

The reference shells out to ``TreeCluster.py -m sum_branch -t 2*size``
(main.py:217) after setting every *labeled* node's edge length to 1.0
(main.py:203-205). sum_branch greedily partitions the leaves in postorder:
at each binary internal node, if the total branch length of the live subtree
exceeds the threshold, the heavier child subtree is cut off as a cluster.
Singleton clusters are reported as -1 (TreeCluster convention), which
divide_tree later drops (main.py:225-237).

Verified against the checked-in toy goldens
(toy_example/train_tree_newick/train_tree.subtrees and the single-clade
variant).

Semantics note: when BOTH child subtrees exceed the threshold at one node,
the default cuts until the node's total is under threshold (a while-loop),
which guarantees the mode's documented contract — every cluster's internal
branch-length sum <= threshold. Upstream TreeCluster's greedy loop performs
a SINGLE cut of the heavier child per node and lets the over-threshold
remainder propagate upward, which can later emit a contract-violating
cluster; that behavior is available as ``single_cut=True`` (CLI:
``divide_tree -tc_single_cut``) for byte-parity with reference-built
libraries on trees that hit the case. The real tool is not installable in
this offline environment, so the single-cut variant mirrors the documented
upstream algorithm, not a line-level diff.

Measured blast radius (tests/test_tree.py::test_sum_branch_ambiguity_*,
ROUND3_NOTES.md): the ambiguous case requires BOTH children's post-cut
totals to land within one edge length of the threshold (each child was
already reduced to <= threshold at its own node), a band of width
edge/threshold. At divide_tree's regime (unit edges on labeled nodes,
threshold 2*850) the band is ~0.06% and totals are near-integers: zero
ambiguous nodes across random-attachment AND balanced unit-edge trees up to
16384 leaves (threshold 1700), so the two modes produce IDENTICAL
partitions there. The case only fires when threshold ~ O(edge length)
(e.g. threshold 5 with edges U[0,2): ~1% of nodes), far below any real
-size; divide_tree warns if it ever fires.
"""

from __future__ import annotations

from .newick import Node, Tree


def sum_branch_clusters(
    tree: Tree,
    threshold: float,
    single_cut: bool = False,
    stats: dict | None = None,
) -> list[list[str]]:
    """Greedy postorder sum_branch clustering.

    Returns clusters in creation order (cut clusters first, the remaining
    root cluster last); each cluster is a list of leaf labels in postorder.
    ``single_cut`` mirrors upstream TreeCluster: at most one cut per node
    (the heavier child), letting an over-threshold remainder propagate.
    ``stats`` (if a dict) receives ``ambiguous_nodes`` — the number of nodes
    where BOTH children exceeded the threshold, i.e. where the two modes can
    diverge — so callers can warn when the partition is mode-sensitive.
    """
    cut: set[int] = set()  # ids of deleted (already clustered) subtree roots
    clusters: list[list[str]] = []
    totals: dict[int, float] = {}
    ambiguous = 0

    def collect_leaves(node: Node) -> list[str]:
        out: list[str] = []
        stack = [node]
        while stack:
            cur = stack.pop()
            if id(cur) in cut:
                continue
            if cur.is_leaf():
                out.append(cur.label)
            else:
                stack.extend(reversed(cur.children))
        return out

    for node in tree.traverse_postorder():
        if node.is_leaf():
            totals[id(node)] = 0.0
            continue
        children = list(node.children)
        if len(children) != 2:
            raise ValueError(
                "sum_branch requires a fully resolved (binary) tree; "
                f"node has {len(children)} children"
            )
        side: list[float] = []
        for c in children:
            if id(c) in cut:
                side.append(0.0)
            else:
                length = c.edge_length or 0.0
                side.append(totals[id(c)] + max(length, 0.0))
        # cut until under threshold: when BOTH subtrees exceed it, a single
        # cut would pass an over-threshold total upward and the parent would
        # then emit a cluster whose internal branch sum violates the mode's
        # contract (possible on large unit-edge trees; a 5-leaf golden never
        # hits it)
        if min(side) > threshold:
            ambiguous += 1  # both children over: the two modes may diverge here
        while side[0] + side[1] > threshold:
            heavy = 0 if side[0] > side[1] else 1
            cluster = collect_leaves(children[heavy])
            cut.add(id(children[heavy]))
            side[heavy] = 0.0
            if cluster:
                clusters.append(cluster)
            if single_cut:
                break  # upstream TreeCluster: one cut per node, remainder propagates
        totals[id(node)] = side[0] + side[1]

    remaining = collect_leaves(tree.root)
    if remaining:
        clusters.append(remaining)
    if stats is not None:
        stats["ambiguous_nodes"] = ambiguous
    return clusters


def assign_clades(clusters: list[list[str]]) -> list[tuple[str, int]]:
    """TreeCluster output numbering: singletons get -1, real clusters get
    1, 2, ... in cluster order; divide_tree then subtracts 1 and drops the
    (now -2) singletons (main.py:235-237). Returns (genome, clade) pairs
    *after* the divide_tree shift, singletons already dropped."""
    out: list[tuple[str, int]] = []
    num = 1
    for cluster in clusters:
        if len(cluster) == 1:
            continue  # TreeCluster -1 -> shifted -2 -> dropped
        for leaf in cluster:
            out.append((leaf, num - 1))
        num += 1
    return out
