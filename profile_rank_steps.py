#!/usr/bin/env python3
"""What a one-rank process group adds to a training step on the card:
``python3 profile_rank_steps.py`` (one NVIDIA card; exits non-zero without one).

A dense distance model and a classifier at full width (k=7, V=8,192, 2048
hidden, 1024 out, 12 classes, batch 16, the default learning rate) train
on STEPS seeded random items (27 steps an epoch) through the trainers'
epoch functions, without a process group and inside a one-rank NCCL group
joined through ``initialize_distributed``, in turns for ROUNDS rounds. In
each round and mode: one warm-up epoch, then one epoch timed on the host
clock (ended by a synchronise); in the last round one more epoch runs
under ``torch.profiler``. Prints one JSON line per model and mode: the
wall ms per step of every round, the device ms per step and idle share of
the profiled epoch, and the TOP kernels by device time per step with their
launches per step; then the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from kf2vecfsw_tpu_torch.defaults import BATCH_SIZE, EMBEDDING_SIZE, HIDDEN_SIZE_FC1, LEARNING_RATE
from kf2vecfsw_tpu_torch.kmer.vocab import canonical_vocab_size
from kf2vecfsw_tpu_torch.models.mlp import Classifier, DistEmbed, init_params_
from kf2vecfsw_tpu_torch.parallel.mesh import initialize_distributed
from kf2vecfsw_tpu_torch.train.step import classifier_epoch, distance_epoch, make_adam

SEED = 20261016
V = canonical_vocab_size(7)
N_CLASSES = 12
ITEMS = 425  # the smoke's ranked subtree: 27 steps of 16
ROUNDS = 4
TOP = 10


@contextlib.contextmanager
def one_rank_group():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "RANK": "0",
                       "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"})
    try:
        if not (initialize_distributed(device="cuda") and dist.get_backend() == "nccl"):
            raise AssertionError("no one-rank NCCL group")
        yield
    finally:
        dist.destroy_process_group()
        for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                    "LOCAL_WORLD_SIZE"):
            os.environ.pop(key)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_rank_steps: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    feats = torch.rand((ITEMS, V), generator=gen, device=dev)
    d = torch.rand((ITEMS, ITEMS), generator=gen, device=dev)
    dist_m = ((d + d.T) * 0.5).fill_diagonal_(0)
    labels = torch.randint(N_CLASSES, (ITEMS,), generator=gen, device=dev)
    with torch.device(dev):
        dense = init_params_(DistEmbed(V, HIDDEN_SIZE_FC1, EMBEDDING_SIZE), gen)
        clf = init_params_(Classifier(V, HIDDEN_SIZE_FC1, N_CLASSES), gen)
    epochs = {
        "dense": (dense, make_adam(dense, LEARNING_RATE),
                  lambda m, o, order: distance_epoch(m, o, feats, dist_m, order, BATCH_SIZE)),
        "classifier": (clf, make_adam(clf, LEARNING_RATE),
                       lambda m, o, order: classifier_epoch(m, o, feats, labels, order, BATCH_SIZE)[0]),
    }
    steps = -(-ITEMS // BATCH_SIZE)
    order_gen = torch.Generator().manual_seed(SEED)
    out = {(name, mode): {"model": name, "mode": mode, "wall_ms_per_step": []}
           for name in epochs for mode in ("no_group", "one_rank")}

    def run(mode: str, profiled: bool) -> None:
        for name, (model, opt, epoch) in epochs.items():
            rec = out[(name, mode)]
            float(epoch(model, opt, torch.randperm(ITEMS, generator=order_gen).to(dev)))
            order = torch.randperm(ITEMS, generator=order_gen).to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec["loss"] = float(epoch(model, opt, order))
            rec["wall_ms_per_step"].append((time.perf_counter() - t0) * 1e3 / steps)
            if not profiled:
                continue
            order = torch.randperm(ITEMS, generator=order_gen).to(dev)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                float(epoch(model, opt, order))
            # kernels, copies and fills only (profile_fsw_steps.py's rule)
            kernels = sorted((e for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
                             key=lambda e: e.device_time_total, reverse=True)
            rec["device_ms_per_step"] = sum(e.device_time_total for e in kernels) / steps / 1e3
            rec["idle_share"] = 1.0 - rec["device_ms_per_step"] / float(np.median(
                rec["wall_ms_per_step"]))
            rec["top"] = [{"kernel": e.key[:100],
                           "device_ms_per_step": e.device_time_total / steps / 1e3,
                           "launches_per_step": e.count / steps} for e in kernels[:TOP]]

    for r in range(ROUNDS):
        run("no_group", r == ROUNDS - 1)
        with one_rank_group():
            run("one_rank", r == ROUNDS - 1)
    for rec in out.values():
        if not (np.isfinite(rec["loss"]) and rec["device_ms_per_step"] > 0):
            raise AssertionError(f"{rec['model']} {rec['mode']}: {rec}")
        print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
