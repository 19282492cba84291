"""Inputs made from the seed: backbone trees, k-mer counts, weights.

Everything here is the benchmark's own: the program receives only what these
functions make. Bulk data is drawn on the device from a ``torch.Generator``
in a few large calls; small decisions (a tree's shape, the lengths' order)
come from a numpy generator. Every seed gets the same set of sizes (genome
lengths, tree size) in another order, so the work of a run does not depend
on its seed.

The random backbone follows ``random_backbone`` of ``chip_smoke.py``
(sequential leaf attachment, edge lengths 0.01-0.21, GC content drifting
from 0.5 along the tree), kept here as a frozen copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.kmers import canonical_vocab, gc_count, revcomp

N_RATE = 0.01  # share of N bases in a genome


def generators(seed: int, device: torch.device) -> tuple[np.random.Generator, torch.Generator]:
    """(numpy generator, torch generator on ``device``) of one seed."""
    return np.random.default_rng(seed), torch.Generator(device=device).manual_seed(seed)


# -- backbone ------------------------------------------------------------------


def random_tree(rng: np.random.Generator, n_leaves: int):
    """A random binary tree on ``n_leaves`` leaves: (children of each inner
    node, edge length above each node, GC content of each leaf in leaf
    order). Leaves are the nodes without children, numbered in order."""
    children, parent, leaves, nxt = {0: [1, 2]}, {1: 0, 2: 0}, [1, 2], 3
    for _ in range(n_leaves - 2):
        target = leaves[int(rng.integers(0, len(leaves)))]
        inner, leaf = nxt, nxt + 1
        nxt += 2
        p = parent[target]
        children[p][children[p].index(target)] = inner
        children[inner] = [target, leaf]
        parent.update({inner: p, target: inner, leaf: inner})
        leaves.append(leaf)
    length = {v: 0.01 + 0.2 * rng.random() for v in range(1, nxt)}
    gc = {0: 0.5}
    stack = [0]
    while stack:
        v = stack.pop()
        for c in children.get(v, ()):
            gc[c] = float(np.clip(gc[v] + rng.normal(0.0, 0.03), 0.25, 0.75))
            stack.append(c)
    order = sorted(leaves)
    return children, length, np.array([gc[v] for v in order]), order


def patristic(children: dict, length: dict, leaf_order: list[int]) -> np.ndarray:
    """(n, n) float64 path lengths between leaves: each pair is set once, at
    its lowest common ancestor, from the two sides' depths below it."""
    index = {v: i for i, v in enumerate(leaf_order)}
    n = len(leaf_order)
    dist = np.zeros((n, n))
    below: dict[int, tuple[np.ndarray, np.ndarray]] = {}  # node -> (leaf rows, depth below node)
    post, stack = [], [0]
    while stack:
        v = stack.pop()
        post.append(v)
        stack.extend(children.get(v, ()))
    for v in reversed(post):
        if v not in children:
            below[v] = (np.array([index[v]]), np.zeros(1))
            continue
        sides = []
        for c in children[v]:
            rows, depth = below.pop(c)
            sides.append((rows, depth + length[c]))
        (ra, da), (rb, db) = sides
        block = da[:, None] + db[None, :]
        dist[np.ix_(ra, rb)] = block
        dist[np.ix_(rb, ra)] = block.T
        below[v] = (np.concatenate([ra, rb]), np.concatenate([da, db]))
    return dist


# -- k-mer counts ----------------------------------------------------------------


def canonical_probabilities(k: int, gc: torch.Tensor) -> torch.Tensor:
    """(n, V) probability of each canonical k-mer (vocab order) in a genome
    of independent bases with GC content ``gc`` (n,): the k-mer's and its
    reverse complement's, which hold as many G and C."""
    codes = canonical_vocab(k)
    n_gc = torch.from_numpy(gc_count(codes, k)).to(gc.device, torch.float64)
    twice = torch.from_numpy((codes != revcomp(codes, k)).astype(np.float64)).to(gc.device)
    g = gc.to(torch.float64)[:, None]
    logp = n_gc * torch.log(g / 2) + (k - n_gc) * torch.log((1 - g) / 2)
    return torch.exp(logp) * (1 + twice)


def genome_counts(gen: torch.Generator, k: int, gc: np.ndarray, lengths: np.ndarray,
                  device: torch.device) -> torch.Tensor:
    """(n, V) float64 canonical k-mer counts of genomes of the given GC
    contents and lengths, with N_RATE of N bases: Poisson draws around the
    expected count of each k-mer's windows."""
    valid = (torch.from_numpy(lengths).to(device, torch.float64) - k + 1) * (1 - N_RATE) ** k
    rates = canonical_probabilities(k, torch.from_numpy(gc).to(device)) * valid[:, None]
    return torch.poisson(rates, generator=gen)


def spread_lengths(rng: np.random.Generator, n: int, lo: int, hi: int) -> np.ndarray:
    """n lengths evenly spread over [lo, hi], in a seeded order."""
    return rng.permutation(np.linspace(lo, hi, n).round().astype(np.int64))


# -- weights -------------------------------------------------------------------


def linear_params(gen: torch.Generator, sizes: list[tuple[str, int, int]],
                  device: torch.device) -> dict[str, torch.Tensor]:
    """Linear layers ``(name, fan_in, fan_out)`` in the (in, out) layout,
    weights and biases uniform in +-1/sqrt(fan_in) (torch.nn.Linear's
    bounds), from one draw: ``{name/w, name/b}``."""
    total = sum((fi + 1) * fo for _, fi, fo in sizes)
    u = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for name, fi, fo in sizes:
        bound = 1.0 / math.sqrt(fi)
        out[f"{name}/w"] = u[at : at + fi * fo].view(fi, fo) * bound
        at += fi * fo
        out[f"{name}/b"] = u[at : at + fo] * bound
        at += fo
    return out


def fsw_params(gen: torch.Generator, k: int, base_dim: int, d_out: int,
               device: torch.device) -> dict[str, torch.Tensor]:
    """The FSW layer's parameters: a standard normal (4, base_dim) lookup,
    slices stacked from orthonormal blocks (the Q of Gaussian d_in x d_in
    matrices) and frequencies 0..d_out-1."""
    d_in = k * base_dim
    lookup = torch.randn(4, base_dim, generator=gen, device=device)
    blocks = -(-d_out // d_in)
    q, _ = torch.linalg.qr(torch.randn(blocks, d_in, d_in, generator=gen, device=device))
    slices = q.reshape(blocks * d_in, d_in)[:d_out].contiguous()
    freqs = torch.arange(d_out, dtype=torch.float32, device=device)
    return {"lookup": lookup, "fsw/slices": slices, "fsw/freqs": freqs}


def model_params(gen: torch.Generator, cfg: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """A subtree distance model of the configuration's family."""
    h, e = cfg["hidden_size"], cfg["embedding_size"]
    if cfg["model"] == "fsw":
        params = fsw_params(gen, cfg["k"], cfg["base_dim"], cfg["fsw_out_dim"], device)
        params.update(linear_params(gen, [("fc1", cfg["fsw_out_dim"], h), ("fc2", h, e)], device))
        return params
    v = len(canonical_vocab(cfg["k"]))
    return linear_params(gen, [("fc1", v, h), ("fc2", h, e)], device)
