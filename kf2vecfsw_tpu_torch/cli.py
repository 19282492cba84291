"""kf2vec CLI of the PyTorch port: the subcommands of the JAX package's
parser (``kf2vecfsw_tpu/cli.py``) that the port runs, with the same flags
and defaults, plus ``-device {cuda,cpu}`` (default ``cuda``) on every
command that uses a device, for a caller who asks for the CPU. The four
trainers run data-parallel over the ranks of a launcher such as
``torch.distributed.run`` (``parallel/mesh.py``); on a grid with a model
axis through ``parallel/mp_check.py``'s ``grid`` worker or a library call
with ``mesh=``.

Commands:
  get_kmers                Genome -> (N, k+1) k-mer point set .npy (FSW input)
  get_frequencies          Genome -> canonical k-mer frequency .kf vector
  divide_tree              Split phylogeny into subtrees (sum_branch)
  scale_tree               Multiply all edge lengths
  get_distances            Patristic distance matrices (.di_mtrx)
  train_classifier         Train the subtree classifier
  classify                 Classify query samples
  train_model_set          Train per-subtree distance models (FSW; dense: -no_fsw)
  query                    Query distance models -> APPLES inputs
  build_library            Wrapper: frequencies+divide+distances+train both
  process_query_data       Wrapper: frequencies+classify+kmers+query
  get_chunks               Genome -> 10kb-window chunk .kf matrices
  train_model_set_chunks   Chunk-streaming distance trainer
  train_classifier_chunks  Chunk-streaming classifier trainer
  get_secondary_classes    2nd/3rd/4th-best classes post-processor
  serve                    Persistent placement daemon (JSON lines on stdin/stdout)

Libraries of dense and of FSW subtree models are served, by
``process_query_data`` once or by the ``serve`` daemon, which keeps the
models on the device between requests. ``train_model_set`` trains FSW
models on get_kmers' ``.npy`` point sets by default and dense models on
``.kf`` vectors with ``-no_fsw``; ``build_library`` builds dense libraries,
as in the JAX package, and so do the chunk trainers, from the per-window
rows of ``get_chunks``.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

from . import __version__
from . import defaults as D

VERSION = f"kf2vec-tpu-torch {__version__}"


def _cmd_get_kmers(args):
    from .ingest.kmers import get_kmers

    get_kmers(args.input_dir, args.output_dir, k=args.k, device=args.device)


def _cmd_get_frequencies(args):
    from .ingest.frequencies import get_frequencies

    get_frequencies(
        args.input_dir, args.output_dir, k=args.k, threads=args.p,
        pseudocount=args.pseudocount, raw_cnt=args.raw_cnt, device=args.device,
    )


def _cmd_divide_tree(args):
    from .ingest.tree_ops import divide_tree

    divide_tree(args.tree, args.size, single_cut=args.tc_single_cut)


def _cmd_scale_tree(args):
    from .ingest.tree_ops import scale_tree

    scale_tree(args.tree, args.factor)


def _cmd_get_distances(args):
    from .ingest.tree_ops import get_distances

    get_distances(args.tree, args.subtrees, args.mode)


def _cmd_train_classifier(args):
    from .train.classifier import train_classifier_func

    files = sorted(glob.glob(os.path.join(args.input_dir, "*.kf")))
    train_classifier_func(
        args.input_dir, files, args.subtrees, args.e, args.hidden_sz, args.batch_sz,
        args.lr, args.lr_min, args.lr_decay, args.seed, args.mask, args.o,
        resume=args.resume, device=args.device, mesh=args.mesh,
    )


def _cmd_classify(args):
    from .infer.classify import classify_func

    files = sorted(glob.glob(os.path.join(args.input_dir, "*.kf")))
    classify_func(args.input_dir, files, args.model, args.seed, args.o, args.block,
                  device=args.device)


def _cmd_train_model_set(args):
    from .train.distance import train_model_set_func

    pattern = "*.kf" if args.no_fsw else "*.npy"
    files = sorted(glob.glob(os.path.join(args.input_dir, pattern)))
    train_model_set_func(
        args.input_dir, files, args.subtrees, args.true_dist, args.e, args.hidden_sz,
        args.embed_sz, args.batch_sz, args.lr, args.lr_min, args.lr_decay, args.clade,
        args.seed, args.o, test_ids_path=args.test_set, save_interval=args.save_interval,
        use_fsw=not args.no_fsw, base_dim=args.base_dim, fswout_dim=args.fswout_dim,
        resume=args.resume, fsw_lazy_refresh=args.fsw_lazy_refresh, device=args.device,
        mesh=args.mesh,
    )


def _cmd_query(args):
    from .infer.query import query_func

    files = sorted(
        glob.glob(os.path.join(args.input_dir, "*.kf"))
        + glob.glob(os.path.join(args.input_dir, "*.npy"))
    )
    query_func(
        args.input_dir, files, args.model, args.classes, args.seed, args.o,
        remap_path=args.remap, block_size=args.block, device=args.device,
    )


def _cmd_get_chunks(args):
    from .ingest.chunks import get_chunks

    get_chunks(
        args.input_dir, args.output_dir, k=args.k, threads=args.p,
        pseudocount=args.pseudocount, device=args.device,
    )


def _cmd_train_model_set_chunks(args):
    from .train.chunks import train_model_set_chunks_func

    files = sorted(glob.glob(os.path.join(args.input_dir, "*.kf")))
    train_model_set_chunks_func(
        args.input_dir, args.input_dir_fullgenomes, files, args.subtrees,
        args.true_dist, args.e, args.hidden_sz, args.embed_sz, args.batch_sz,
        args.lr, args.lr_min, args.lr_decay, args.clade, args.seed, args.cap, args.o,
        resume=args.resume, device=args.device, mesh=args.mesh,
    )


def _cmd_train_classifier_chunks(args):
    from .train.chunks import train_classifier_chunks_func

    files = sorted(glob.glob(os.path.join(args.input_dir, "*.kf")))
    train_classifier_chunks_func(
        args.input_dir, args.input_dir_fullgenomes, files, args.subtrees, args.e,
        args.hidden_sz, args.batch_sz, args.lr, args.lr_min, args.lr_decay,
        args.seed, args.mask, args.cap, args.o,
        resume=args.resume, device=args.device, mesh=args.mesh,
    )


def _cmd_get_secondary_classes(args):
    from .infer.secondary import write_secondary_classes

    write_secondary_classes(args.classes)


def _cmd_serve(args):
    import contextlib
    import sys

    from .infer.serve import ServeDaemon, _exit_daemon

    daemon = ServeDaemon(args)
    if args.warm:
        with contextlib.redirect_stdout(sys.stderr):  # stdout carries only the protocol
            daemon.handle_warm({})
    rc = daemon.serve()
    _exit_daemon(daemon, rc)  # hard exit if wedged workers were abandoned
    raise SystemExit(rc)


def _cmd_build_library(args) -> dict[str, float]:
    """get_frequencies -> divide_tree -> get_distances -> train_classifier ->
    train_model_set with dense models (main.py:569-622). The tree's outputs
    are written next to ``-tree``. Returns the wall seconds of each stage."""
    if args.mode == "full_only":
        raise SystemExit(
            "build_library needs per-subtree distance matrices to train the "
            "distance models; -mode full_only produces only the full-tree "
            "matrix (use 'hybrid' or 'subtrees_only')"
        )
    from .device import resolve_device
    from .ingest.frequencies import get_frequencies
    from .ingest.tree_ops import divide_tree, get_distances
    from .train.classifier import train_classifier_func
    from .train.distance import train_model_set_func

    resolve_device(args.device)
    seconds = {}
    t0 = time.perf_counter()
    print("\n==> Computing k-mer frequences\n")
    get_frequencies(
        args.input_dir, args.output_dir, k=args.k, threads=args.p,
        pseudocount=args.pseudocount, raw_cnt=args.raw_cnt, device=args.device,
    )
    t1 = time.perf_counter()
    seconds["get_frequencies"] = t1 - t0
    print("\n==> Splitting phylogeny into subtrees\n")
    subtrees = divide_tree(args.tree, args.size)
    t2 = time.perf_counter()
    seconds["divide_tree"] = t2 - t1
    print("\n==> Computing distance matrices\n")
    get_distances(args.tree, subtrees, args.mode)
    tree_dir = os.path.split(args.tree)[0]
    t3 = time.perf_counter()
    seconds["get_distances"] = t3 - t2

    print("\n==> Training classifier model\n")
    files = sorted(glob.glob(os.path.join(args.output_dir, "*.kf")))
    train_classifier_func(
        args.output_dir, files, subtrees, args.cl_epochs, args.cl_hidden_sz,
        args.cl_batch_sz, args.cl_lr, args.cl_lr_min, args.cl_lr_decay, args.cl_seed,
        False, args.output_dir, device=args.device,
    )
    t4 = time.perf_counter()
    seconds["train_classifier"] = t4 - t3
    print("\n==> Training distance models\n")
    train_model_set_func(
        args.output_dir, files, subtrees, tree_dir, args.di_epochs, args.di_hidden_sz,
        args.di_embed_sz, args.di_batch_sz, args.di_lr, args.di_lr_min,
        args.di_lr_decay, None, args.di_seed, args.output_dir, use_fsw=False,
        device=args.device,
    )
    seconds["train_model_set"] = time.perf_counter() - t4
    print("\n==> Building library step is completed!\n")
    return seconds


def _cmd_process_query_data(args) -> dict[str, float]:
    """get_frequencies -> classify -> get_kmers (once per k of the library's
    FSW models) -> query (main.py:626-651). Returns the wall seconds of each
    stage."""
    from .device import resolve_device
    from .infer.classify import classify_func
    from .infer.query import query_func
    from .ingest.frequencies import get_frequencies
    from .ingest.kmers import get_kmers
    from .train.checkpoint import fsw_ks

    resolve_device(args.device)
    seconds = {}
    t0 = time.perf_counter()
    print("\n==> Computing k-mer frequences\n")
    get_frequencies(
        args.input_dir, args.output_dir, k=args.k, threads=args.p,
        pseudocount=args.pseudocount, device=args.device,
    )
    t1 = time.perf_counter()
    seconds["get_frequencies"] = t1 - t0
    print("\n==> Classifying query samples\n")
    files = sorted(glob.glob(os.path.join(args.output_dir, "*.kf")))
    classify_func(
        args.output_dir, files, args.classifier_model, args.cl_seed, args.output_dir,
        D.DEFAULT_BLOCK_SZ, device=args.device,
    )
    t2 = time.perf_counter()
    seconds["classify"] = t2 - t1
    # FSW subtree models read {name}_k{k}.npy point sets, not .kf vectors
    for fk in fsw_ks(args.distance_model):
        print(f"\n==> Computing k-mer point sets for FSW models (k={fk})\n")
        get_kmers(args.input_dir, args.output_dir, k=fk, threads=args.p, device=args.device)
    t3 = time.perf_counter()
    seconds["get_kmers"] = t3 - t2
    print("\n==> Computing model distances\n")
    query_func(
        args.output_dir, files, args.distance_model, args.output_dir, args.di_seed,
        args.output_dir, device=args.device,
    )
    seconds["query"] = time.perf_counter() - t3
    print("\n==> Query processing step is completed!\n")
    return seconds


def _add_k(p, lo=D.MIN_K_LEN, hi=D.MAX_K_LEN):
    p.add_argument(
        "-k", type=int, choices=list(range(lo, hi + 1)), default=D.DEFAULT_K_LEN,
        help=f"K-mer length [{lo}-{hi}]. Default: {D.DEFAULT_K_LEN}", metavar="K",
    )


def _add_p(p):
    cpus = os.cpu_count() or 1
    p.add_argument(
        "-p", type=int, default=cpus,
        help=f"Max number of processors to use [1-{cpus}]. Default: {cpus}", metavar="P",
    )


def _add_device(p):
    p.add_argument("-device", choices=["cuda", "cpu"], default="cuda",
                   help="Device to run on. Default: cuda (cpu only when asked for)")


def _add_resume(p):
    p.add_argument("-resume", action="store_true",
                   help="Resume from the last autosaved trainer state")


def _add_train_common(p, epochs_default):
    p.add_argument("-e", type=int, default=epochs_default,
                   help=f"Number of epochs. Default: {epochs_default}")
    p.add_argument("-hidden_sz", type=int, default=D.HIDDEN_SIZE_FC1,
                   help=f"Hidden size. Default: {D.HIDDEN_SIZE_FC1}")
    p.add_argument("-batch_sz", type=int, default=D.BATCH_SIZE,
                   help=f"Batch size. Default: {D.BATCH_SIZE}")
    p.add_argument("-lr", type=float, default=D.LEARNING_RATE,
                   help=f"Start learning rate. Default: {D.LEARNING_RATE}")
    p.add_argument("-lr_min", type=float, default=D.LEARNING_RATE_MIN,
                   help=f"Minimum learning rate. Default: {D.LEARNING_RATE_MIN}")
    p.add_argument("-lr_decay", type=float, default=D.LEARNING_RATE_DECAY,
                   help=f"Learning rate decay. Default: {D.LEARNING_RATE_DECAY}")
    p.add_argument("-seed", type=int, default=D.SEED, help=f"Random seed. Default: {D.SEED}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=f"K-mer frequency to distance (PyTorch/CUDA)\n{VERSION}",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("-v", "--version", action="version", version=VERSION)
    # the trainers' grid of ranks (parallel.mesh.make_mesh): no flag reaches
    # it, as none does in the JAX CLI; parallel/mp_check.py's grid worker
    # sets it on the parsed arguments
    parser.set_defaults(mesh=None)
    sub = parser.add_subparsers(title="commands", dest="command")

    p = sub.add_parser("get_kmers", description="Extract kmers and frequencies from FASTA files")
    p.add_argument("-input_dir")
    p.add_argument("-output_dir")
    _add_k(p)
    _add_device(p)
    p.set_defaults(func=_cmd_get_kmers)

    p = sub.add_parser("get_frequencies", description="Process a library of reference genome-skims or assemblies")
    p.add_argument("-input_dir")
    p.add_argument("-output_dir")
    _add_k(p)
    _add_p(p)
    p.add_argument("-pseudocount", action="store_true",
                   help="Computes k-mer counts with 0.5 pseudocount added to each frequency value")
    p.add_argument("-raw_cnt", action="store_true",
                   help="Computes raw k-mer counts without normalization")
    _add_device(p)
    p.set_defaults(func=_cmd_get_frequencies)

    p = sub.add_parser("divide_tree", description="Divides input phylogeny into subtrees.")
    p.add_argument("-tree", help="Input phylogeny (a .newick/.nwk format)")
    p.add_argument("-size", type=int, default=D.DEFAULT_SUBTREE_SZ,
                   help=f"Size of the subtree. Default: {D.DEFAULT_SUBTREE_SZ}")
    # hidden: upstream-TreeCluster single-cut ambiguity resolution
    p.add_argument("-tc_single_cut", action="store_true", help=argparse.SUPPRESS)
    p.set_defaults(func=_cmd_divide_tree)

    p = sub.add_parser("scale_tree", description="Scales all edges in the tree by multiplier.")
    p.add_argument("-tree")
    p.add_argument("-factor", type=float, default=D.DEFAULT_MULTIPLIER,
                   help=f"Multiplier. Default: {D.DEFAULT_MULTIPLIER}")
    p.set_defaults(func=_cmd_scale_tree)

    p = sub.add_parser("get_distances", description="Computes distance matrices")
    p.add_argument("-tree", required=True)
    p.add_argument("-subtrees")
    p.add_argument("-mode", type=str, default="subtrees_only", metavar="",
                   help="Ways to perform distance computation [subtrees_only]. Default: subtrees_only")
    p.set_defaults(func=_cmd_get_distances)

    p = sub.add_parser("train_classifier", description="Train classifier model based on backbone subtrees")
    p.add_argument("-input_dir")
    p.add_argument("-subtrees")
    _add_train_common(p, D.DEFAULT_CL_EPOCHS)
    p.add_argument("-mask", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("-o", help="Model output path")
    _add_resume(p)
    _add_device(p)
    p.set_defaults(func=_cmd_train_classifier)

    p = sub.add_parser("classify", description="Classifies query inputs using previously trained classifier model")
    p.add_argument("-input_dir")
    p.add_argument("-model")
    p.add_argument("-block", type=int, default=D.DEFAULT_BLOCK_SZ,
                   help=f"Block size for file processing. Default: {D.DEFAULT_BLOCK_SZ}")
    p.add_argument("-seed", type=int, default=D.SEED)
    p.add_argument("-o", help="Output path")
    _add_device(p)
    p.set_defaults(func=_cmd_classify)

    p = sub.add_parser("train_model_set", description="Trains individual models for each subtree")
    p.add_argument("-input_dir")
    p.add_argument("-test_set")
    p.add_argument("-true_dist")
    p.add_argument("-subtrees")
    _add_train_common(p, D.DEFAULT_DI_EPOCHS)
    p.add_argument("-embed_sz", type=int, default=D.EMBEDDING_SIZE,
                   help=f"Embedding size. Default: {D.EMBEDDING_SIZE}")
    p.add_argument("-clade", type=int, nargs="*", help="Clade number to train. Default: all")
    p.add_argument("-save_interval", type=int,
                   help="Save model after specified interval of epochs. Default: last")
    p.add_argument("-o", help="Model output path")
    p.add_argument("-no_fsw", action="store_true", help="Keep original model")
    p.add_argument("-fswout_dim", type=int, default=D.FSW_OUT_DIM)
    p.add_argument("-base_dim", type=int, default=D.FSW_BASE_DIM)
    p.add_argument("-fsw_lazy_refresh", type=int, default=None,
                   help="FSW acceleration (extension): re-sort the FSW "
                        "projections every N steps instead of every step "
                        "(shared-vocab clades only). Default: auto — engage "
                        f"at N={D.FSW_LAZY_AUTO_REFRESH} when the clade fits "
                        "the per-device plane budget. 0 = exact per-step sort")
    _add_resume(p)
    _add_device(p)
    p.set_defaults(func=_cmd_train_model_set)

    p = sub.add_parser("query", description="Query models")
    p.add_argument("-input_dir")
    p.add_argument("-model")
    p.add_argument("-classes")
    p.add_argument("-block", type=int, default=D.DEFAULT_BLOCK_SZ)
    p.add_argument("-seed", type=int, default=D.SEED)
    p.add_argument("-remap", help='Remap file with alternative output names ("label" and "new_label" columns in .tsv format)')
    p.add_argument("-o", help="Output path")
    _add_device(p)
    p.set_defaults(func=_cmd_query)

    p = sub.add_parser("build_library", description="Wrapper: get_frequencies, divide_tree, get_distance, train_classifier, train_model_set")
    p.add_argument("-input_dir")
    p.add_argument("-output_dir")
    _add_k(p)
    _add_p(p)
    p.add_argument("-pseudocount", action="store_true")
    p.add_argument("-raw_cnt", action="store_true")
    p.add_argument("-tree")
    p.add_argument("-size", type=int, default=D.DEFAULT_SUBTREE_SZ)
    p.add_argument("-mode", type=str, default="hybrid", choices=["full_only", "hybrid", "subtrees_only"], metavar="")
    for prefix, epochs in (("cl", D.DEFAULT_CL_EPOCHS), ("di", D.DEFAULT_DI_EPOCHS)):
        p.add_argument(f"-{prefix}_epochs", type=int, default=epochs)
        p.add_argument(f"-{prefix}_hidden_sz", type=int, default=D.HIDDEN_SIZE_FC1)
        p.add_argument(f"-{prefix}_batch_sz", type=int, default=D.BATCH_SIZE)
        p.add_argument(f"-{prefix}_lr", type=float, default=D.LEARNING_RATE)
        p.add_argument(f"-{prefix}_lr_min", type=float, default=D.LEARNING_RATE_MIN)
        p.add_argument(f"-{prefix}_lr_decay", type=float, default=D.LEARNING_RATE_DECAY)
        p.add_argument(f"-{prefix}_seed", type=int, default=D.SEED)
    p.add_argument("-di_embed_sz", type=int, default=D.EMBEDDING_SIZE)
    _add_device(p)
    p.set_defaults(func=_cmd_build_library)

    p = sub.add_parser("process_query_data", description="Wrapper: get_frequencies, classify, query")
    p.add_argument("-input_dir")
    p.add_argument("-output_dir")
    _add_k(p)
    _add_p(p)
    p.add_argument("-pseudocount", action="store_true")
    p.add_argument("-classifier_model")
    p.add_argument("-cl_seed", type=int, default=D.SEED)
    p.add_argument("-distance_model")
    p.add_argument("-di_seed", type=int, default=D.SEED)
    _add_device(p)
    p.set_defaults(func=_cmd_process_query_data)

    p = sub.add_parser("get_chunks", description="Process a library of reference genome-skims or assemblies")
    p.add_argument("-input_dir")
    p.add_argument("-output_dir")
    _add_k(p)
    _add_p(p)
    p.add_argument("-pseudocount", action="store_true")
    _add_device(p)
    p.set_defaults(func=_cmd_get_chunks)

    p = sub.add_parser("train_model_set_chunks", description="Trains individual models for each subtree using chunked genomes as input")
    p.add_argument("-input_dir")
    p.add_argument("-input_dir_fullgenomes")
    p.add_argument("-true_dist")
    p.add_argument("-subtrees")
    _add_train_common(p, D.DEFAULT_DI_EPOCHS)
    p.add_argument("-embed_sz", type=int, default=D.EMBEDDING_SIZE)
    p.add_argument("-clade", type=int, nargs="*")
    p.add_argument("-cap", action="store_true",
                   help="Reduces memory consuption for input dataset (caps k-mer frequences at maximum of 255)")
    p.add_argument("-o", help="Model output path")
    _add_resume(p)
    _add_device(p)
    p.set_defaults(func=_cmd_train_model_set_chunks)

    p = sub.add_parser("train_classifier_chunks", description="Train classifier model based on backbone subtrees (genomes split into chunks)")
    p.add_argument("-input_dir")
    p.add_argument("-input_dir_fullgenomes")
    p.add_argument("-subtrees")
    _add_train_common(p, D.DEFAULT_CL_EPOCHS)
    p.add_argument("-mask", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("-cap", action="store_true")
    p.add_argument("-o", help="Model output path")
    _add_resume(p)
    _add_device(p)
    p.set_defaults(func=_cmd_train_classifier_chunks)

    p = sub.add_parser("get_secondary_classes", description="Emit 2nd/3rd/4th-best classification outputs")
    p.add_argument("classes", help="Path to classes.out")
    p.set_defaults(func=_cmd_get_secondary_classes)

    p = sub.add_parser(
        "serve",
        description=(
            "Persistent placement server: JSON-lines requests on stdin, one "
            "JSON response per line on stdout; models stay device-resident "
            "between requests (commands: ping, warm, stats, place, "
            "place_features, quit)"
        ),
    )
    p.add_argument("-classifier_model", required=True)
    p.add_argument("-distance_model", required=True)
    _add_k(p)
    _add_p(p)
    p.add_argument("-pseudocount", action="store_true")
    p.add_argument("-cl_seed", type=int, default=D.SEED)
    p.add_argument("-di_seed", type=int, default=D.SEED)
    p.add_argument("-warm", action="store_true",
                   help="Preload every model to the device before accepting requests")
    p.add_argument("-request_timeout", type=float, default=0.0,
                   help="Per-request watchdog seconds: a request that wedges "
                        "(e.g. a stalled device call) is answered with "
                        "{ok: false} after this long and the daemon keeps "
                        "serving. 0 disables. Env: KF2VEC_SERVE_REQUEST_TIMEOUT_S")
    _add_device(p)
    p.set_defaults(func=_cmd_serve)

    return parser


# the commands that use a device: each joins a launcher's process group
# first (the JAX package's _DEVICE_COMMANDS, cli.py:490-504)
_DEVICE_COMMANDS = {
    "get_frequencies", "get_kmers", "get_chunks", "train_classifier",
    "train_model_set", "train_classifier_chunks", "train_model_set_chunks",
    "classify", "query", "build_library", "process_query_data", "serve",
}
# the commands that run data-parallel over ranks; the others would write the
# same files once per rank, so more than one rank refuses them
_RANKED_COMMANDS = {
    "train_classifier", "train_model_set", "train_classifier_chunks", "train_model_set_chunks",
}


def main(argv=None):
    """Run one subcommand; returns what the command returns (stage seconds
    for build_library and process_query_data, else None). Under a launcher
    (``python -m torch.distributed.run --nproc_per_node=N -m
    kf2vecfsw_tpu_torch train_model_set ...``) a device command joins the
    process group first, and ``-device cuda`` means the rank's own card."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command in _DEVICE_COMMANDS:
        import torch.distributed as dist

        from .parallel.mesh import initialize_distributed

        if (initialize_distributed(device=args.device) and dist.get_world_size() > 1
                and args.command not in _RANKED_COMMANDS):
            raise SystemExit(
                f"{args.command} does not run over ranks: every rank would write the same "
                f"files. Run it in one process; {', '.join(sorted(_RANKED_COMMANDS))} train "
                "data-parallel"
            )
    if hasattr(args, "func"):
        return args.func(args)
    parser.print_help()
    return None
