"""kf2vec CLI of the PyTorch port: the serving subcommands of the JAX
package's parser (``kf2vecfsw_tpu/cli.py``), with the same flags and
defaults, plus ``-device {cuda,cpu}`` (default ``cuda``) for a caller who
asks for the CPU.

Commands:
  get_kmers                Genome -> (N, k+1) k-mer point set .npy (FSW input)
  get_frequencies          Genome -> canonical k-mer frequency .kf vector
  classify                 Classify query samples
  query                    Query distance models -> APPLES inputs
  process_query_data       Wrapper: frequencies+classify+kmers+query

Libraries of dense and of FSW subtree models are served. Training
(``build_library`` and its steps) stays with the JAX package until later
slices of the port.
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


def _cmd_classify(args):
    from .infer.classify import classify_func

    files = sorted(glob.glob(os.path.join(args.input_dir, "*.kf")))
    classify_func(args.input_dir, files, args.model, args.seed, args.o, args.block,
                  device=args.device)


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


def _fsw_ks(distance_model: str) -> list[int]:
    """The k of every FSW subtree model of a library, from checkpoint meta
    only (the weights are not read)."""
    from .train.checkpoint import fsw_k_from_meta, load_checkpoint_meta

    ks = set()
    for ckpt in sorted(glob.glob(os.path.join(distance_model, "model_subtree_*.ckpt"))):
        try:
            model_name, meta = load_checkpoint_meta(ckpt)
            if model_name == "NeuralNetFSW":
                ks.add(fsw_k_from_meta(meta))
        except (OSError, ValueError, KeyError) as e:
            # as the JAX package: an unreadable model fails the query only
            # if a genome is classified into its subtree
            print(f"WARNING: could not inspect {ckpt}: {e}")
    return sorted(ks)


def _cmd_process_query_data(args) -> dict[str, float]:
    """get_frequencies -> classify -> get_kmers (once per k of the library's
    FSW models) -> query (main.py:626-651). Returns the wall seconds of each
    stage."""
    from .device import resolve_device
    from .infer.classify import classify_func
    from .infer.query import query_func
    from .ingest.frequencies import get_frequencies
    from .ingest.kmers import get_kmers

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
    for fk in _fsw_ks(args.distance_model):
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=f"K-mer frequency to distance (PyTorch/CUDA)\n{VERSION}",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("-v", "--version", action="version", version=VERSION)
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

    p = sub.add_parser("classify", description="Classifies query inputs using previously trained classifier model")
    p.add_argument("-input_dir")
    p.add_argument("-model")
    p.add_argument("-block", type=int, default=D.DEFAULT_BLOCK_SZ,
                   help=f"Block size for file processing. Default: {D.DEFAULT_BLOCK_SZ}")
    p.add_argument("-seed", type=int, default=D.SEED)
    p.add_argument("-o", help="Output path")
    _add_device(p)
    p.set_defaults(func=_cmd_classify)

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

    return parser


def main(argv=None):
    """Run one subcommand; returns what the command returns (stage seconds
    for process_query_data, else None)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if hasattr(args, "func"):
        return args.func(args)
    parser.print_help()
    return None
