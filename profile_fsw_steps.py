#!/usr/bin/env python3
"""Where an FSW training step's time goes on the card:
``python3 profile_fsw_steps.py`` (one NVIDIA card; exits non-zero without one).

For each route of the FSW distance trainer (exact and lazy, shared-vocab and
per-genome) at full width (k=7, V=8,192, base_dim 4, 512 slices, 2048
hidden, 1024 out, batch 16, lr 1e-5), on seeded random inputs: one warm-up
epoch, one timed epoch of STEPS steps, then one more under
``torch.profiler`` (CPU and CUDA activity; a lazy route's one refresh falls
in the warm-up). Prints one JSON line per route: the wall time per step of
the timed epoch (host clock, ended by a synchronise) and of the profiled
one (the profiler slows the host), the device time per step (the traced
kernels, copies and fills summed), the device's idle share in the timed
epoch, the exact coefficients' and the sort's launches per step, the
traced kernels of a plain cos/sinc chain (a scan, sin or cos: none where
the exact route runs the coefficient kernels), and the TOP kernels by device
time per step, with their launches per step; then the card's
``nvidia-smi`` name and power limit.

``python3 profile_fsw_steps.py --cells`` profiles instead the exact route
at the shapes of the benchmark's cells ``fsw_k7.train_exact`` (k = 7,
16 genomes' weights over the 8,192-entry vocab a step, shared route) and
``fsw_k10.train_exact`` (k = 10, 16 point sets of 239,000-524,783 real
points padded to 646,000 a step, per genome, the training chunks of
``auto_slice_chunk``), with the peak device memory of the timed epoch.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from kf2vecfsw_tpu_torch.defaults import (
    BATCH_SIZE,
    EMBEDDING_SIZE,
    FSW_BASE_DIM,
    FSW_OUT_DIM,
    HIDDEN_SIZE_FC1,
    LEARNING_RATE,
)
from kf2vecfsw_tpu_torch.kmer.vocab import (
    FSW_BASE_MAP,
    canonical_vocab_codes,
    canonical_vocab_size,
    codes_to_digit_matrix,
)
from kf2vecfsw_tpu_torch.kernels.refresh import exact_coefficients
from kf2vecfsw_tpu_torch.kernels.sort import sort_rows
from kf2vecfsw_tpu_torch.models.fsw import FSWDistEmbed, auto_slice_chunk, init_fsw_dist_embed_
from kf2vecfsw_tpu_torch.train.distance import pad_point_sets
from kf2vecfsw_tpu_torch.train.fsw_lazy import LazyPlanes, lazy_distance_epoch, pick_refresh_group
from kf2vecfsw_tpu_torch.train.step import distance_epoch, make_adam

SEED = 20261016
K = 7
STEPS = 20  # steps of the profiled epoch
POINTS = (1_000, 2_000)  # k-mers per per-genome point set: 1-2 kb contigs
TOP = 12
# the exact cells: k, items, padded N (0: the shared route's vocab), real
# points an item, steps an epoch
CELLS = {"fsw_k7.train_exact": (7, 64, 0, None, 4),
         "fsw_k10.train_exact": (10, 32, 646_000, (239_000, 524_784), 2)}


def features(route: str, rng, n: int) -> np.ndarray:
    """(n, V) vocab weights with every k-mer present (full genomes), or (n,
    N, k+1) padded point sets of distinct canonical k-mers (short contigs)."""
    if route.endswith("shared"):
        return rng.random((n, canonical_vocab_size(K)), dtype=np.float32) + np.float32(0.01)
    codes = canonical_vocab_codes(K)
    mats = []
    for m in rng.integers(*POINTS, n):
        pick = np.sort(rng.choice(codes, int(m), replace=False))
        mats.append(np.column_stack((codes_to_digit_matrix(pick, K, FSW_BASE_MAP),
                                     rng.random(int(m)) + 0.01)).astype(np.float32))
    return pad_point_sets(mats)


def cell_features(cell: str, rng) -> np.ndarray:
    """(n, V) vocab weights, a fifth of the k-mers absent, or (n, N, k+1)
    point sets of random bases and real-point counts padded to N."""
    k, n, n_pad, real, _ = CELLS[cell]
    if not n_pad:
        w = rng.random((n, canonical_vocab_size(k)), dtype=np.float32)
        w[w < 0.2] = 0.0
        return w
    x = np.zeros((n, n_pad, k + 1), np.float32)
    for i, m in enumerate(rng.integers(*real, n)):
        x[i, :m, :k] = rng.integers(0, 4, (m, k))
        x[i, :m, k] = rng.random(m) + np.float32(0.01)
    return x


def profile_route(route: str, dev: torch.device) -> dict:
    rng = np.random.default_rng(SEED)
    k, steps = K, STEPS
    if route in CELLS:
        k, steps = CELLS[route][0], CELLS[route][4]
        x = torch.from_numpy(cell_features(route, rng)).to(dev)
    else:
        x = torch.from_numpy(features(route, rng, STEPS * BATCH_SIZE)).to(dev)
    n = x.shape[0]
    d = np.abs(rng.normal(size=(n, n))).astype(np.float32)
    dist = torch.from_numpy(d + d.T).fill_diagonal_(0).to(dev)
    model = init_fsw_dist_embed_(
        FSWDistEmbed(k, FSW_BASE_DIM, FSW_OUT_DIM, HIDDEN_SIZE_FC1, EMBEDDING_SIZE),
        torch.Generator().manual_seed(SEED)).to(dev)
    opt = make_adam(model, LEARNING_RATE)
    gen = torch.Generator().manual_seed(SEED)
    if route.startswith("lazy"):
        # R = the three epochs' steps: one refresh, at the warm-up's start
        shared = route == "lazy_shared"
        planes = LazyPlanes(x, shared, 3 * STEPS, STEPS,
                            pick_refresh_group(FSW_OUT_DIM, x.shape[1], dev,
                                               points=None if shared else (K, FSW_BASE_DIM),
                                               items=x.shape[0]))
        epoch = lambda order: lazy_distance_epoch(model, opt, planes, dist, order, BATCH_SIZE)
    else:
        planes = None
        epoch = lambda order: distance_epoch(model, opt, x, dist, order, BATCH_SIZE)
    float(epoch(torch.randperm(n, generator=gen).to(dev)))  # warm-up

    def timed_epoch() -> tuple[float, float]:
        order = torch.randperm(n, generator=gen).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(epoch(order))  # the epoch's one fetch synchronises
        return loss, (time.perf_counter() - t0) * 1e3 / steps

    torch.cuda.reset_peak_memory_stats()
    launches = exact_coefficients.launches, sort_rows.launches
    loss, wall_ms = timed_epoch()
    launches = [(now - then) / steps for now, then in
                zip((exact_coefficients.launches, sort_rows.launches), launches)]
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, profiled_wall_ms = timed_epoch()
    # kernels, copies and fills only: a CPU op's self device time repeats its
    # kernels', and a user annotation's device range (Adam's step) spans them
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
                     key=lambda e: e.device_time_total, reverse=True)
    device_ms = sum(e.device_time_total for e in kernels) / steps / 1e3
    return {
        "route": route, "shape": list(x.shape), "steps": steps, "loss": loss,
        "refreshes": planes.refreshes if planes else 0,
        "slice_chunk": auto_slice_chunk(BATCH_SIZE, x.shape[1], FSW_OUT_DIM, dev, True),
        "wall_ms_per_step": wall_ms, "profiled_wall_ms_per_step": profiled_wall_ms,
        "device_ms_per_step": device_ms, "idle_share": 1.0 - device_ms / wall_ms,
        "exact_coefficients_launches_per_step": launches[0],
        "chain_kernels": [e.key[:120] for e in kernels if "scan_innermost" in e.key
                          or "native::sin" in e.key or "native::cos" in e.key],
        "sort_rows_launches_per_step": launches[1], "peak_gib": peak / 2**30,
        "top": [{"kernel": e.key[:120], "device_ms_per_step": e.device_time_total / steps / 1e3,
                 "launches_per_step": e.count / steps} for e in kernels[:TOP]],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_fsw_steps: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    routes = (tuple(CELLS) if sys.argv[1:] == ["--cells"]
              else ("exact_shared", "lazy_shared", "exact_pergenome", "lazy_pergenome"))
    for route in routes:
        out = profile_route(route, dev)
        if not (np.isfinite(out["loss"]) and out["device_ms_per_step"] > 0
                and out["refreshes"] == route.startswith("lazy")):
            raise AssertionError(f"{route}: loss {out['loss']}, {out['refreshes']} refreshes, "
                                 f"{out['device_ms_per_step']} device ms a step")
        print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
