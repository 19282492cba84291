"""Spawn N local ranks and check what they train (the port's counterpart of
``kf2vecfsw_tpu/parallel/mp_check.py``).

``launch`` starts one process per rank with a launcher's variables set
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` on a free local port, and
``KF2VEC_DIST_BACKEND``), as ``torch.distributed.run`` would, waits for
all of them within a timeout, and raises with the output of the rank at
fault; on a failure or at the timeout it kills every rank. A rank runs
any command line: the CLI (``python -m kf2vecfsw_tpu_torch train_model_set
... -device cuda``), or a worker of this module:

    python -m kf2vecfsw_tpu_torch.parallel.mp_check epoch PROBLEM.npz OUT.npz [PROBLEM OUT ...]
    python -m kf2vecfsw_tpu_torch.parallel.mp_check sampler CHUNKS_DIR SEED DRAWS DEVICE OUT.npy
    python -m kf2vecfsw_tpu_torch.parallel.mp_check count CODES.npy K DEVICE OUT.npy
    python -m kf2vecfsw_tpu_torch.parallel.mp_check grid N_DATA N_MODEL TRAINER ARGS...

``epoch`` trains one epoch of each PROBLEM.npz (``write_epoch_problem``) on
the sharded plan of the grid (world / n_model) x n_model and writes the
loss, the full parameters and the last batch's summed gradients (gathered
over the model axis) and the rank's own cut; ``sampler`` reads each rank's
slice of the chunk `.kf` files of CHUNKS_DIR into the genome-sharded store
and draws the span rows of epoch 0 through it; ``count`` runs
``count_canonical_sharded`` of the encoded bases of CODES.npy and prints
the rank's ``kmer_hist`` launches (``kmer_hist launches: N``); ``grid``
runs one trainer command of the CLI (``train_classifier ... -device
cuda``) on the grid ``make_mesh(N_DATA, N_MODEL)``, the model axis that no
CLI flag reaches, and prints the rank's ``sort_rows`` launches
(``sort_rows launches: N``). Rank 0 writes every OUT, or, when OUT holds
``{rank}``, every rank writes its own.

The CPU tests run the ranks with gloo; ``chip_smoke.py`` runs two of them
sharing one card (gloo on CUDA tensors), since NCCL takes one card per rank.
By hand, two ranks of a trainer on the grid 1 x 2 (the model cut in two),
rank 0's output printed::

    python -c "from kf2vecfsw_tpu_torch.parallel.mp_check import launch, worker; \\
        argv = 'train_model_set -input_dir npy -subtrees t.subtrees -true_dist . -o out'; \\
        print(launch([worker('grid') + ['1', '2'] + argv.split()] * 2, 'gloo', 3600)[0][1])"
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argvs: list[list[str]], backend: str, timeout_s: float,
           check: bool = True) -> list[tuple[int, str]]:
    """Run rank r's command line ``argvs[r]`` for every r, all at once, as
    ranks of one process group on this host; returns each rank's (exit
    code, output). With ``check``, the first rank to fail kills the others
    (which would wait in a collective) and raises ``RuntimeError`` with its
    output; without, every rank runs to its end. Past ``timeout_s`` every
    rank is killed and ``TimeoutError`` raised."""
    world = len(argvs)
    base = {**os.environ, "WORLD_SIZE": str(world),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(free_port()), "KF2VEC_DIST_BACKEND": backend}
    base.setdefault("OMP_NUM_THREADS", "1")  # torchrun's default for several ranks
    base["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, base.get("PYTHONPATH")) if p)
    logs = [tempfile.TemporaryFile() for _ in argvs]
    procs = [subprocess.Popen(argv, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                              env={**base, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r, (argv, log) in enumerate(zip(argvs, logs))]

    def output(r: int) -> str:
        logs[r].seek(0)
        return logs[r].read().decode(errors="replace")

    def raise_if_failed() -> None:
        failed = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
        if check and failed:
            r = failed[0]
            raise RuntimeError(f"rank {r} of {world} failed (exit {procs[r].returncode}):\n"
                               f"{output(r)[-4000:]}")

    try:
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            raise_if_failed()
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after {timeout_s} s; rank 0:\n"
                                   f"{output(0)[-4000:]}")
            time.sleep(0.05)
        raise_if_failed()
        return [(p.returncode, output(r)) for r, p in enumerate(procs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()


def worker(mode: str) -> list[str]:
    """The command line that runs this module's ``mode`` worker."""
    return [sys.executable, "-m", "kf2vecfsw_tpu_torch.parallel.mp_check", mode]


# -- workers -----------------------------------------------------------------------


def run_count(codes_path: str, k: str, device: str, out_path: str) -> None:
    import numpy as np

    from ..device import resolve_device
    from ..kernels.histogram import kmer_hist
    from .counting import count_canonical_sharded
    from .mesh import data_mesh, initialize_distributed, is_coordinator

    initialize_distributed(device=device)
    mesh = data_mesh(resolve_device(device))
    kmer_hist.launches = 0
    hist = count_canonical_sharded(np.load(codes_path), int(k), mesh)
    print(f"kmer_hist launches: {kmer_hist.launches}", flush=True)
    if is_coordinator():
        np.save(out_path, hist)


def run_sampler(chunks_dir: str, seed: int, draws: int, device: str, out_path: str) -> None:
    import glob

    import numpy as np
    import torch

    from ..device import resolve_device
    from ..train.chunks import DeviceChunkStore, epoch_plan, load_chunk_store_process_sliced
    from .mesh import data_mesh, initialize_distributed, is_coordinator

    initialize_distributed(device=device)
    mesh = data_mesh(resolve_device(device))
    paths = sorted(glob.glob(os.path.join(chunks_dir, "*.kf")))
    local, counts, width, _ = load_chunk_store_process_sliced(paths, mesh, cap=False)
    store = DeviceChunkStore.build_sharded(local, counts, width, mesh)
    _, spans = epoch_plan(seed, 0, counts[: len(paths)], draws)
    rows = store.batch(torch.from_numpy(spans).to(mesh.device)).cpu().numpy()
    if is_coordinator():
        np.save(out_path, rows)


def write_epoch_problem(path: str, kind: str, feats, target, order, batch_size: int, lr: float,
                        params: dict, n_model: int = 1, refresh: int = 0, resume_state: str = "",
                        save_state: str = "") -> None:
    """The inputs of an ``epoch`` worker: ``kind`` "distance" (``target`` the
    true distances) or "classifier" (``target`` the labels), the item
    order, the batch size, the learning rate, the initial params in the
    JAX layout (a dense or an FSW model: (n, V) features take the FSW
    shared-vocab forward, (n, N, k+1) the per-genome one), the grid's
    model axis and, for FSW, ``refresh`` R > 0 for the lazy route at R (its
    refresh groups of 4 items), 0 for the exact one. ``resume_state``
    names a trainer state to start from instead of the params (its params
    and Adam state, cut for the grid), ``save_state`` where the trainer
    state after the epoch is autosaved (gathered, as the trainers do)."""
    import numpy as np

    from ..train.checkpoint import _flatten

    np.savez(path, kind=kind, feats=feats, target=target, order=order, batch_size=batch_size,
             lr=lr, n_model=n_model, refresh=refresh, resume_state=resume_state,
             save_state=save_state, **{f"params::{k}": v for k, v in _flatten(params).items()})


def run_epoch(problem_path: str, out_path: str) -> None:
    import copy

    import numpy as np
    import torch

    from ..models.mlp import params_from_jax, params_to_jax
    from ..train.checkpoint import _flatten, _unflatten
    from ..train.fsw_lazy import LazyPlanes, lazy_distance_epoch
    from ..train.resume import start_or_resume
    from ..train.step import classifier_epoch, distance_epoch
    from .mesh import gather_module, initialize_distributed, is_coordinator, make_mesh

    initialize_distributed(device="cpu")
    with np.load(problem_path) as data:
        kind, refresh = str(data["kind"]), int(data["refresh"])
        feats, target = torch.from_numpy(data["feats"]), torch.from_numpy(data["target"])
        order, batch = torch.from_numpy(data["order"]), int(data["batch_size"])
        lr = float(data["lr"])
        mesh = make_mesh(None, int(data["n_model"]), "cpu")
        resume_state, save_state = str(data["resume_state"]), str(data["save_state"])
        params = _unflatten({k[len("params::"):]: data[k] for k in data.files
                             if k.startswith("params::")})
    st = start_or_resume(params_from_jax(params), torch.Generator(), order.numel(), resume_state,
                         bool(resume_state), None, lr, torch.device("cpu"), mesh, shard=True)
    model, opt = st.model, st.opt
    if kind == "classifier":
        loss, acc = classifier_epoch(model, opt, feats, target, order, batch, mesh=mesh)
    elif refresh > 0:
        planes = LazyPlanes(feats, feats.dim() == 2, refresh, -(-order.numel() // batch), 4)
        loss, acc = lazy_distance_epoch(model, opt, planes, target, order, batch, mesh=mesh), None
    else:
        loss, acc = distance_epoch(model, opt, feats, target, order, batch, mesh=mesh), None
    if save_state:
        st.autosave(save_state, st.start_epoch)
    grads = copy.deepcopy(model)
    with torch.no_grad():
        for g, p in zip(grads.parameters(), model.parameters()):
            g.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    full, full_grads = gather_module(model), gather_module(grads)
    if is_coordinator() or "{rank}" in out_path:
        np.savez(out_path.format(rank=mesh.rank), loss=float(loss),
                 acc=float("nan") if acc is None else float(acc),
                 **{f"params::{k}": v for k, v in _flatten(params_to_jax(full)).items()},
                 **{f"grads::{k}": v for k, v in _flatten(params_to_jax(full_grads)).items()},
                 **{f"local::{k}": p.detach().numpy() for k, p in model.named_parameters()})


def run_grid(n_data: str, n_model: str, argv: list[str]) -> None:
    """One trainer command of the CLI on the grid ``make_mesh(n_data,
    n_model)``; prints the rank's ``sort_rows`` launches."""
    from ..cli import _RANKED_COMMANDS, build_parser
    from ..kernels.sort import sort_rows
    from .mesh import initialize_distributed, make_mesh

    args = build_parser().parse_args(argv)
    if args.command not in _RANKED_COMMANDS:
        raise SystemExit(f"grid runs a trainer ({', '.join(sorted(_RANKED_COMMANDS))}), "
                         f"not {args.command!r}")
    initialize_distributed(device=args.device)
    args.mesh = make_mesh(int(n_data), int(n_model), args.device)
    sort_rows.launches = 0
    args.func(args)
    print(f"sort_rows launches: {sort_rows.launches}", flush=True)


def main(argv: list[str] | None = None) -> None:
    from .mesh import shutdown_distributed

    argv = sys.argv[1:] if argv is None else argv
    mode, rest = argv[0], argv[1:]
    if mode == "epoch":
        for problem, out in zip(rest[::2], rest[1::2]):
            run_epoch(problem, out)
    elif mode == "sampler":
        run_sampler(rest[0], int(rest[1]), int(rest[2]), rest[3], rest[4])
    elif mode == "count":
        run_count(*rest)
    elif mode == "grid":
        run_grid(rest[0], rest[1], rest[2:])
    else:
        raise SystemExit(f"unknown mode {mode!r}: use epoch, sampler, count or grid")
    shutdown_distributed()


if __name__ == "__main__":
    main()
