"""The port's tree commands against the JAX package's: ``divide_tree``,
``get_distances`` in all three modes and ``scale_tree`` write byte-identical
files, on random binary trees of several seeds (random edge lengths, some
internal nodes labelled as support values, which divide_tree's unit-length
pre-pass then treats as unit edges) and on a deep pectinate tree. Both
packages write next to the ``-tree`` input, so each gets its own copy."""

import os

import numpy as np
import pytest

from kf2vecfsw_tpu.cli import main as jax_main
from kf2vecfsw_tpu_torch.cli import main


def _random_newick(rng, n_leaves):
    """Random binary tree by sequential leaf attachment, as newick text."""
    children = {0: [1, 2]}
    parent = {1: 0, 2: 0}
    leaves = [1, 2]
    nxt = 3
    for _ in range(n_leaves - 2):
        target = leaves[int(rng.integers(0, len(leaves)))]
        inner, leaf = nxt, nxt + 1
        nxt += 2
        p = parent[target]
        children[p][children[p].index(target)] = inner
        children[inner] = [target, leaf]
        parent.update({inner: p, target: inner, leaf: inner})
        leaves.append(leaf)
    names = {v: f"G{i:04d}" for i, v in enumerate(sorted(leaves))}

    def text(v):
        length = f":{rng.random() * 0.3:.6g}" if v else ""
        if v not in children:
            return names[v] + length
        label = f"{rng.integers(50, 101)}" if v and rng.random() < 0.5 else ""
        return "(" + ",".join(text(c) for c in children[v]) + ")" + label + length

    return text(0) + ";"


def _pectinate_newick(depth):
    nwk = ""
    for i in range(depth):
        nwk = f"(L{i}:0.5" + ("," + nwk + ":1.25)" if nwk else f",L{depth}:0.75)")
    return nwk + ";"


def _run_both(tmp_path, nwk, argv_of):
    """Run one command of each CLI on its own copy of the tree."""
    for tag, run in (("jax", jax_main), ("port", main)):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        tree = d / "tree.nwk"
        if not tree.exists():
            tree.write_text(nwk)
        run(argv_of(str(tree)))


def _assert_same_files(jax_dir, port_dir):
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir))
    for n in names:
        assert (port_dir / n).read_bytes() == (jax_dir / n).read_bytes(), n
    return names


@pytest.mark.parametrize("seed,n_leaves,size", [(0, 40, 5), (1, 120, 12), (2, 300, 40)])
def test_tree_commands_are_byte_identical(tmp_path, seed, n_leaves, size):
    nwk = _random_newick(np.random.default_rng(seed), n_leaves)
    _run_both(tmp_path, nwk, lambda t: ["divide_tree", "-tree", t, "-size", str(size)])
    for mode in ("subtrees_only", "full_only", "hybrid"):
        _run_both(tmp_path, nwk, lambda t: ["get_distances", "-tree", t, "-subtrees",
                                            t.replace(".nwk", ".subtrees"), "-mode", mode])
    _run_both(tmp_path, nwk, lambda t: ["scale_tree", "-tree", t, "-factor", "37.5"])
    names = _assert_same_files(tmp_path / "jax", tmp_path / "port")
    assert "tree.subtrees" in names and "tree_full.di_mtrx" in names
    assert "tree_r37.5.nwk" in names
    subtree_files = [n for n in names if "_subtree_" in n]
    assert len(subtree_files) >= 2
    # single-cut mode (hidden flag) too
    for d in (tmp_path / "jax", tmp_path / "port"):
        for n in os.listdir(d):
            if n != "tree.nwk":
                os.remove(d / n)
    _run_both(tmp_path, nwk, lambda t: ["divide_tree", "-tree", t, "-size", str(size),
                                        "-tc_single_cut"])
    _assert_same_files(tmp_path / "jax", tmp_path / "port")


def test_deep_pectinate_tree(tmp_path):
    nwk = _pectinate_newick(1500)
    _run_both(tmp_path, nwk, lambda t: ["divide_tree", "-tree", t, "-size", "100"])
    _run_both(tmp_path, nwk, lambda t: ["get_distances", "-tree", t, "-subtrees",
                                        t.replace(".nwk", ".subtrees"), "-mode", "subtrees_only"])
    _run_both(tmp_path, nwk, lambda t: ["scale_tree", "-tree", t])
    names = _assert_same_files(tmp_path / "jax", tmp_path / "port")
    assert "tree_r100.nwk" in names and len([n for n in names if "_subtree_" in n]) >= 2


def test_get_distances_without_subtrees_exits(tmp_path):
    tree = tmp_path / "t.nwk"
    tree.write_text("((A:1,B:2):1,C:3);")
    with pytest.raises(SystemExit):
        main(["get_distances", "-tree", str(tree), "-mode", "hybrid"])
    with pytest.raises(SystemExit):
        main(["get_distances", "-tree", str(tree), "-subtrees", str(tree), "-mode", "bogus"])
