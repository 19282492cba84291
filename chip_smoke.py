#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA card (Hopper: the kernels build for sm_90a) and nvcc; exits
non-zero without one. Phases, each of which fails the run if it fails:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every CUDA source of the port compiled from the checkout, one
   nvcc per source, all started together, and the host text library
   (``io/native/textio.cpp``) with g++;
3. kernels vs plain versions, on the card:
   - ``kmer_hist`` against ``kmer_hist_reference`` (exact), and against the
     numpy ground truth at k=7, on edge-case genomes (N, lowercase,
     multi-record, a 2 Mb repeat, empty, shorter than k, tile seams, a 9 Mb
     genome);
   - ``sort_rows`` against ``sort_rows_reference`` at R in {1, 33, 4096}
     rows, N from 1 to 131,073 (the cluster path above 16,384 with its
     seams, the radix path above 131,072), one payload row per key
     row or per 512, on random, tied / signed-zero,
     sorted and reversed keys, and at a model-axis rank's shapes (256 x
     8,192 with one payload row, 4,096 x 8,192 with 16), and on the radix
     path at k=10's lengths (262,144, 300,007 and 524,800 at R in {1, 33},
     one payload row or one per key row), at its tile seams (RADIX_SEAM_*,
     R = 33), on a row of 1,100,000 (R = 2) and on adversarial keys
     (RADIX_ADVERSARIAL: all equal, where ``perm`` must be the identity,
     only +-0.0, ascending, descending, one digit in a whole tile), those
     with P in {1, R, R/3}, with ``cluster_elems()`` equal to
     the host's ``CLUSTER_ELEMS``: sorted keys
     bit-equal, ``perm`` a permutation that maps keys and payload to the
     outputs exactly, and equal to the plain (stable) version's on every
     row, ties included;
4. main paths at full width, each driven with the launch counts set to 0
   just before it and read just after:
   - dense: ``process_query_data`` (k=7, a classifier 8192->2048->12 and 12
     subtree models 8192->2048->1024 with 850 anchors each);
   - FSW: the same classifier and 12 FSW subtree models (k=7, base_dim 4,
     512 slices, 2048 hidden, 1024 out), so ``get_kmers`` and the FSW
     forward run too;
   random weights from a seeded torch.Generator, on 32 query genomes on the
   card, then 4 of them again with ``-device cpu``;
   - serve: for each of those two libraries, an in-process ``ServeDaemon``
     on the card, from empty serving caches, fed one request at a time
     through a pipe with the launch counts set to 0 before each: ping, warm
     (13 models, at least the library's parameter bytes resident), place on
     the 32 raw genomes (``kmer_hist`` launches, and ``sort_rows`` for the
     FSW library), place_features on phase 4's features twice (the second
     adds no checkpoint or anchor miss and adds hits) and quit; every reply
     is JSON, `.kf`, `.npy` and classes.out equal process_query_data's
     bytes, APPLES and `.emb` its bytes or its cuda-vs-cpu tolerances (the
     log says which held); then ``python -m kf2vecfsw_tpu_torch serve
     -warm`` as a subprocess on the dense library (ping, place, quit), whose
     stdout must hold only JSON lines and which must exit with 0;
   - build_library: ``build_library`` on the card at full width (k=7,
     classifier 8192->2048->C, subtree models 8192->2048->1024, batch 16,
     default learning rates, ``-size 850``) over a seeded random backbone of
     1,700 genomes of 100-200 kb (1% N) in at least two subtrees, cut to 5
     classifier and 5 distance epochs; every file of the library checked,
     no loss NaN; the trained library then serves the 32 queries; and a
     small backbone (48 genomes, ``-size 12``, 2 epochs, full widths) built
     on the card and on the CPU from the same seed agrees: `.kf`,
     `.subtrees` and `.di_mtrx` bytes identical, checkpoints, classes and
     exported CSVs within the REBUILD_* tolerances;
   - train_fsw: FSW ``train_model_set`` on the card at full width (k=7,
     base_dim 4, 512 slices, 2048 hidden, 1024 out, batch 16, default
     learning rates): ``get_kmers`` over the build's backbone, then default
     flags (the lazy sort-refresh at R=128, shared-vocab) over every
     subtree for FSW_EPOCHS epochs, ``-fsw_lazy_refresh 0`` (exact, shared)
     on the smallest subtree, and short contigs of 1-2 kb (the per-genome
     route, lazy and exact); each run's route lines, files and losses are
     checked and ``sort_rows`` must launch outside the exports; the
     trained FSW library serves the 32 queries; and a small backbone
     trained with default flags on the card and on the CPU from one seed
     agrees within the FSW_REBUILD_* tolerances;
   - train_chunks: ``get_chunks`` on the card (k=7, 10 kb windows) over
     CHUNK_PER_CLADE genomes of each of the build's subtrees, then
     ``train_classifier_chunks`` and ``train_model_set_chunks`` at full
     width (the build's full-genome `.kf` files, batch 16, default learning
     rates) for CHUNK_EPOCHS epochs on the device-resident store; every
     file and loss checked; the chunk library serves the 32 queries and
     ``get_secondary_classes`` ranks its classes.out; one subtree retrained
     for 2 epochs on the device store and on the host store
     (``KF2VEC_CHUNK_DEVICE_BUDGET=1``) takes the same batches bit for bit;
     the chunk `.kf` of 4 genomes from ``-device cpu`` equals the card's;
     and a small chunk backbone (CHUNK_RB_*) trained on the card and on the
     CPU agrees within the dense rebuild's tolerances;
   - ranks: data-parallel training (``parallel/``) at full width (k=7,
     hidden 2048, embedding 1024, batch 16, 512 FSW slices) for
     RANKS_EPOCHS epochs: ``train_classifier`` and
     ``train_classifier_chunks`` on the 192 genomes of the chunk phase,
     dense and FSW ``train_model_set`` (the default lazy route and
     ``-fsw_lazy_refresh 0``) on the build's smallest subtree (425
     genomes) and ``train_model_set_chunks`` on its 64 genomes of the chunk
     phase. (a) Each without a process group, then in a one-rank NCCL group
     joined through ``initialize_distributed``: the checkpoints equal, bit
     for bit or within RANKS_W1_RTOL. (b) Two ranks sharing the card over
     gloo, spawned by ``parallel/mp_check.py``, each writing to its own
     directory: only rank 0 writes, the ranks' params bit-equal (the
     trainers' checksum all-reduce), the checkpoints and exports within the
     rebuild's Adam sign-flip bound of (a)'s; then
     ``count_canonical_sharded`` of the 9 Mb query at R = 2, exact against
     one launch. (c) Two cards on NCCL when the machine has them, else one
     line saying it did not run;
   - model_axis: tensor-parallel training on the grid (1, 2)
     (``parallel.mesh.make_mesh``, two ranks sharing the card over gloo,
     each through ``parallel/mp_check.py``'s ``run_grid``): the ranks
     phase's ``train_classifier``, dense and FSW ``train_model_set`` (lazy
     and exact) at full width, each rank holding 1,024 of the 2,048 hidden
     units and 256 of the 512 FSW slices; only rank 0 writes, the gathered
     params bit-equal on both ranks, the checkpoints and exports within the
     rebuild's Adam sign-flip bound of the ranks phase's runs without a
     group, and every FSW training sort on both ranks one of 256 rows;
   - fsw_k8: FSW at k=8 (V = 32,896, so every training and query sort
     takes ``sort_rows``' cluster path) at full width on the 48-genome
     backbone: ``get_kmers -k 8`` on cuda and on cpu (`.npy` bytes
     identical), ``get_frequencies -k 8`` and ``train_classifier`` (2
     epochs), ``train_model_set`` with default flags (lazy, shared-vocab) on
     every subtree and ``-fsw_lazy_refresh 0`` on subtree 0, 2 epochs each,
     the CPU training subtrees 0 and 1 and subtree 0 again (checkpoints and
     exports within the FSW rebuild's tolerances), and the trained library
     serving the 32 queries, 4 of them again on the CPU (within
     FSW_RTOL / FSW_ATOL); the cluster path must launch in the lazy and the
     exact training and in the query;
   - fsw_k9: FSW at k=9 (V = 131,072, upstream's largest canonical
     vocabulary: every training sort takes ``sort_rows``' cluster path, and
     the shared kernels read the weights unstaged) at full width
     on one subtree of 8 random genomes of 300-400 kb: ``get_kmers -k 9`` on
     cuda and on cpu (`.npy` bytes identical), ``train_model_set`` with
     default flags (lazy, shared-vocab) and ``-fsw_lazy_refresh 0`` (exact),
     2 epochs each on the card and on the CPU (checkpoints and exports
     within the FSW rebuild's tolerances), and ``query`` of 2 genomes on the
     card and on the CPU (within FSW_RTOL / FSW_ATOL, the export too); then
     the timings of fsw_k9's shapes: the lazy refresh's planes kernel at 850
     items, the training chunk's sort (128 x 131,072) and its exact
     coefficient kernels on 16 items;
   - fsw_k10: FSW at k=10 (V = 524,800) at full width on a backbone of 16
     random genomes of 300-400 kb (1% N, ``-size 8``), whose point sets of
     about 230,000-290,000 k-mers put every sort on the radix path:
     ``get_kmers -k 10``, ``train_model_set`` with default flags (the
     per-genome lazy route) on every subtree and ``-fsw_lazy_refresh 0``
     (per-genome exact) on the largest, 2 epochs each, the exact run traced
     through ``KF2VEC_PROFILE_DIR`` into a directory of the phase's own
     (its second epoch's trace must hold the radix kernels of
     ``sort_rows.cu``); ``query`` of 4 of the genomes on the card and of 2
     of them with ``-device cpu`` (the plain path on the carried
     checkpoint), whose embeddings, and the export's, agree within
     FSW_RTOL / FSW_ATOL; ``sort_rows`` must launch in the lazy, exact and
     query runs, every launch on the radix path (``radix_launches``) and
     never on the cluster path; then the device memory of
     one refresh group (the group ``pick_refresh_group`` chose) and of one
     sliced forward (``auto_slice_chunk``'s chunk, 16 genomes) against the
     budgets' counts, beside the counts copied from the JAX package; and
     (C6) the device memory of a shared-route lazy refresh at k=9 widths
     (V = 131,072, 512 slices, 16 items in the groups
     ``pick_refresh_group`` picks) against ``shared_refresh_bytes``, the
     plain version's count and an upper bound where ``refresh_planes``'
     kernel runs (the peak must not pass it), and against the kernel
     route's own stages, with one ``refresh_planes`` launch;
   - zoo: every ``models/zoo.py`` model at kf2vec's default widths (input
     8,192 from phase 4's `.kf` rows, hidden 2,048, embedding 1,024, 12
     classes, batch 16): ``MLP`` of depth 2, 3 and 4, both classifiers,
     ``MLPBN`` in training (its running statistics too) and eval mode,
     ``CNN`` single and double, ``ClassifierTrans`` (16 heads, FFN 2,048)
     and ``BiRNN`` (2 layers of 1,024 over 16 windows), each forward on the
     card against the same module's CPU forward within ZOO_TIGHT or
     ZOO_LOOSE;
   - long genome: one genome of more than 2^31 bases (a 1 Mb block repeated
     LONG_REPEATS times) counted on the card in overlapping pieces, exact
     against R x the block's counts + (R - 1) x its junction's;
5. timings: stage wall times of the main paths, and each kernel against
   its plain version, a one-library-call yardstick and its bound at the
   main path's shape (``kmer_hist``: 16 genomes of 5 Mb, k=7, and the same
   batch of homopolymers and of dinucleotide repeats; ``sort_rows``: 16
   genomes x 512 slices = 8,192 rows of 8,192, the FSW training sort of
   512 rows of 8,192 with one payload row, a model-axis rank's 256 x 8,192
   and 4,096 x 8,192, and on the cluster path 8,192 rows of 32,896 (a k=8
   query block), 512 of 32,896 and 512 of 131,072 (the shared-vocab sorts
   at k=8 and k=9), and on the radix path 512 rows of 262,144 (one k=10
   genome's refresh), 1,024 rows of 524,800 with 16 payload rows (a k=10
   query block) and 512 rows of 646,000 (fsw_k10.train_lazy's refresh);
   the sort's backward, an unsort scatter, at 512 and 8,192 rows of 8,192;
   ``refresh_planes`` at the lazy training
   cell's 850 items x 512 slices x 8,192, against its plain version, beside
   its operations bound and its 30 ms goal; ``pergenome_planes`` at the k=10
   cell's group, 512 slices x 646,000 points (503,934 real) at k=10, against
   its plain version, beside its bytes bound), with CUDA events; the stage
   wall times
   of build_library, its trainers' steps per second over epochs 2-5, its
   exports' seconds (str(np.float32) formatting apart) and its peak device
   memory; each FSW training route's seconds, steps per second (with and
   without the refreshes), refreshes and peak device memory; ``kmer_hist``
   at the get_chunks shape (PHASE5_CHUNK_WINDOWS windows of 10 kb, k=7) and
   the chunk sampler's batch of 2 x 16 span rows from the device store and
   from the host store; get_chunks' seconds (counting and formatting
   apart) and both chunk trainers' steps per second and seconds outside
   the epochs; the serve daemon's seconds to ready, for warm and for each
   placement, with their phases and peak device memory, beside
   process_query_data's; host text I/O, plain Python against the C++
   library, formatting and parsing 1,700 `.kf` rows of 8,192 frequencies
   and 850 rows of 1,024 float32, the bytes and values equal; each ranked
   trainer's steps/s over epoch 2 without a group, in the one-rank group and
   at two ranks sharing the card, with the bytes all-reduced per step, the
   sharded count's seconds and the phase's; on the grid (1, 2) each
   trainer's steps/s over epoch 2, the bytes all-reduced per step on each
   group, each rank's sort_rows launches and rows per call, and the phase's
   seconds.

The last three lines of standard output are the kernel report (JSON), the
card's ``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
...}``; they are printed only when every phase passed.
"""

from __future__ import annotations

import copy
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from kf2vecfsw_tpu_torch.cli import build_parser
from kf2vecfsw_tpu_torch.cli import main as cli_main
from kf2vecfsw_tpu_torch.defaults import (
    BATCH_SIZE,
    DEFAULT_SUBTREE_SZ,
    EMBEDDING_SIZE,
    FEATURES_SCALER,
    FSW_BASE_DIM,
    FSW_OUT_DIM,
    HIDDEN_SIZE_FC1,
    LEARNING_RATE,
    LEARNING_RATE_DECAY,
    LEARNING_RATE_MIN,
)
from kf2vecfsw_tpu_torch.infer.cache import clear_all as clear_serving_caches
from kf2vecfsw_tpu_torch.infer.query import read_embeddings_csv, read_embeddings_csv_plain
from kf2vecfsw_tpu_torch.infer.serve import ServeDaemon
from kf2vecfsw_tpu_torch.ingest import chunks as ingest_chunks
from kf2vecfsw_tpu_torch.io import kf as kf_io
from kf2vecfsw_tpu_torch.io.fasta import INVALID, encode_bases, read_sequences_raw
from kf2vecfsw_tpu_torch.io.native import lib as textio_lib
from kf2vecfsw_tpu_torch.kernels import build
from kf2vecfsw_tpu_torch.kernels.refresh import (
    exact_coefficients,
    exact_coefficients_grad,
    exact_coefficients_grad_reference,
    exact_coefficients_reference,
    exact_coefficients_shared,
    exact_coefficients_shared_grad,
    pergenome_planes,
    pergenome_planes_reference,
    quantile_coefficients,
    refresh_planes,
    refresh_planes_reference,
    scratch_bytes,
)
from kf2vecfsw_tpu_torch.kernels.histogram import kmer_hist, kmer_hist_reference, tile_windows
from kf2vecfsw_tpu_torch.kernels.sort import (
    CLUSTER_ELEMS,
    TILE_ELEMS,
    cluster_elems,
    cluster_shape,
    sort_rows,
    sort_rows_reference,
    sort_transient_bytes,
    tile_elems,
)
from kf2vecfsw_tpu_torch.kmer import counter as counter_mod
from kf2vecfsw_tpu_torch.kmer.counter import KmerCounter, concat_with_separators, count_canonical_numpy
from kf2vecfsw_tpu_torch.kmer.vocab import canonical_vocab_codes, canonical_vocab_size
from kf2vecfsw_tpu_torch.models import fsw as fsw_model
from kf2vecfsw_tpu_torch.models import zoo
from kf2vecfsw_tpu_torch.models.fsw import FSWDistEmbed, init_fsw_dist_embed_, unsort
from kf2vecfsw_tpu_torch.models.mlp import (
    Classifier,
    DistEmbed,
    init_params_,
    params_from_jax,
    params_to_jax,
)
from kf2vecfsw_tpu_torch.parallel.counting import count_canonical_sharded
from kf2vecfsw_tpu_torch.parallel.mesh import (
    BACKEND_ENV,
    all_reduce_,
    data_mesh,
    initialize_distributed,
    is_coordinator,
    shutdown_distributed,
)
from kf2vecfsw_tpu_torch.parallel.mp_check import free_port, launch, run_grid
from kf2vecfsw_tpu_torch.train import chunks as train_chunks
from kf2vecfsw_tpu_torch.train import classifier as train_classifier
from kf2vecfsw_tpu_torch.train import distance as train_distance
from kf2vecfsw_tpu_torch.train import fsw_lazy
from kf2vecfsw_tpu_torch.train.checkpoint import _flatten as flatten_params
from kf2vecfsw_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from kf2vecfsw_tpu_torch.train.schedule import step_lr
from kf2vecfsw_tpu_torch.train.step import bucket_items
from kf2vecfsw_tpu_torch.utils.profiling import PROFILE_DIR_ENV

SEED = 20261016
K_MAIN = 7
N_CLASSES = 12
N_ANCHORS = 850  # defaults.DEFAULT_SUBTREE_SZ
N_QUERIES = 32
BIG_GENOME = 9_000_000  # > 2^23 bases: the JAX package's chunked B2 route
PHASE5_G, PHASE5_LEN = 16, 5_000_000  # one kernel batch of typical bacterial genomes
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
# integer operations: an H100 SXM SM has 64 INT32 lanes (half its 128 FP32
# lanes; the 67 TFLOP/s fp32 figure counts an FMA as two), so 132 SMs x 64
# lanes x 1.98 GHz boost = 16.7e12 integer operations per second
H100_INT_OPS_PER_S = 132 * 64 * 1.98e9
KERNEL_SOURCE = "kf2vecfsw_tpu_torch/kernels/csrc/kmer_hist.cu"
REPLACES = (
    "kf2vecfsw_tpu/kernels/histogram.py:511 (_hist_kernel_batch, B1); "
    "kf2vecfsw_tpu/kernels/histogram.py:54 (_hist_kernel, B2)"
)
SORT_SOURCE = "kf2vecfsw_tpu_torch/kernels/csrc/sort_rows.cu"
SORT_REPLACES = (
    "kf2vecfsw_tpu/kernels/sort.py:58 (_bitonic_kernel via sort_rows, B3); "
    "the lax.sort calls at kf2vecfsw_tpu/models/fsw.py:65,75,120,131"
)
SORT_ROWS = (1, 33, 4096)
# the tile path to 16,384; the cluster path to 131,072 (1 block of 1024 threads
# to 17,408, 2 to 34,816, ...; the items a thread step every 1,024 blocks' worth);
# the radix path past it
SORT_LENGTHS = (1, 2, 7, 128, 513, 2080, 8192, 8193, 16384, 16385, 17408, 17409, 24577, 32768,
                32769, 32896, 34816, 34817, 49153, 131071, 131072, 131073)
# the radix path's lengths (k = 10 point sets, its vocab of 524,800), at R in
# {1, 33}: the lengths phase fsw_k10 sorts
RADIX_SORT_ROWS, RADIX_SORT_LENGTHS = (1, 33), (262_144, 300_007, 524_800)
SORT_KINDS = ("normal", "ties_and_signed_zeros", "sorted", "reversed")
# the radix path past 131,072 at R = 33 and P in {1, R, R/3}: its first
# length and tile seams 16,384 j +- 1 (9, 16 and 32 tiles); a row of 68 tiles
# at R = 2; and adversarial keys at 300,007: all equal (perm the identity),
# only +-0.0, ascending, descending, and sharing their top three bytes (one
# digit takes every tile in passes 2-4)
RADIX_SEAM_ROWS, RADIX_SEAM_LENGTHS = 33, (131_073, 147_455, 147_457, 262_143, 262_145,
                                           524_287, 524_289)
RADIX_LONG_ROWS, RADIX_LONG_LENGTH = 2, 1_100_000
RADIX_ADVERSARIAL = (33, 300_007, ("all_equal", "signed_zeros", "sorted", "reversed",
                                   "top_bytes_shared"))
PHASE5_SORT = (16 * FSW_OUT_DIM, 8192, 16)  # rows, N, payload rows: one FSW query block
# the cluster path's rows: a query block at k=8 (V = 32,896), the shared-vocab
# sort at k=8 and at k=9
PHASE5_SORT_LONG = ((16 * FSW_OUT_DIM, 32896, 16), (FSW_OUT_DIM, 32896, 1),
                    (FSW_OUT_DIM, 131072, 1))
LONG_SORT_GOAL_MS = 6.0  # the redesign's goal at 8,192 x 32,896
REFRESH_SOURCE = "kf2vecfsw_tpu_torch/kernels/csrc/lazy_refresh.cu"
REFRESH_REPLACES = ("no Pallas kernel: the shared lazy refresh's XLA ops at "
                    "kf2vecfsw_tpu/models/fsw.py:337 (fsw_lazy_refresh)")
# phase 5: the shared lazy refresh's planes at the training cell's shape:
# items, slices (k = K_MAIN, V = V_MAIN)
PHASE5_REFRESH = (850, FSW_OUT_DIM)
# its bound: lane instructions a coefficient needs (two sincospif, about 30
# f32 operations for delta and d delta / d xi, 4k = 28 segment adds) over
# the card's issue rate, 132 SMs x 128 lanes x 1.98 GHz
REFRESH_INSTR_PER_COEFF = 120
H100_LANE_INSTR_PER_S = 132 * 128 * 1.98e9
REFRESH_GOAL_MS = 30.0  # the kernel's goal at PHASE5_REFRESH
PERGENOME_REPLACES = ("no Pallas kernel: the per-genome lazy refresh's XLA ops at "
                      "kf2vecfsw_tpu/models/fsw.py:468 (fsw_lazy_refresh_pergenome)")
EXACT_REPLACES = ("no Pallas kernel: the exact forwards' XLA ops at kf2vecfsw_tpu/models/fsw.py "
                  "(fsw_embed, fsw_embed_shared) and their autograd")
# phase 5: the exact forwards' coefficients at fsw_k10.train_exact's chunk
# (items, slices, N, real points an item; the last chunk's frequencies) and
# at fsw_k7.train_exact's step (items, slices; V = V_MAIN)
PHASE5_EXACT_ROWS = (16, 32, 646_000, 503_934)
PHASE5_EXACT_SHARED = (16, FSW_OUT_DIM)
# the forward's lane instructions a coefficient: one cospif, the sinc's
# series, the prefix and a product (the backward's, delta and its slope,
# are REFRESH_INSTR_PER_COEFF less the segment sums: counted as those)
EXACT_VALUE_INSTR_PER_COEFF = 60
# phase 5: the per-genome refresh's planes at fsw_k10.train_lazy's group: slices,
# N (the cell's padded point sets), real points (its longest genome's), k = K10
PHASE5_PERGENOME = (FSW_OUT_DIM, 646_000, 503_934)
# the radix path's rows: one k = 10 genome's refresh sort (512 slices of a
# padded point set), a k = 10 query block after auto_slice_chunk (16
# genomes x 64 slices of 524,800) and fsw_k10.train_lazy's refresh sort
PHASE5_SORT_RADIX = ((FSW_OUT_DIM, 262_144, 1), (2 * FSW_OUT_DIM, 524_800, 16),
                     (FSW_OUT_DIM, 646_000, 1))
# cuda vs cpu on the FSW path: cos(pi xi cbar) with xi up to 511 multiplies
# the fp32 cumsum's rounding, which differs between the devices, by ~1.6e3
FSW_RTOL, FSW_ATOL = 1e-3, 1e-4
DENSE_MODEL_BYTES = 4 * (canonical_vocab_size(K_MAIN) * HIDDEN_SIZE_FC1 + HIDDEN_SIZE_FC1 * EMBEDDING_SIZE)
# build_library at full width: a 1,700-genome backbone in subtrees of
# -size 850; genomes and epochs cut (2,000 / 8,000 epochs by default)
BUILD_LEAVES, BUILD_SIZE, BUILD_EPOCHS = 1700, DEFAULT_SUBTREE_SZ, 5
BUILD_GENOME = (100_000, 200_000)
# the same widths on a small backbone, built on the card and on the CPU
REBUILD_LEAVES, REBUILD_SIZE, REBUILD_EPOCHS = 48, 12, 2
REBUILD_GENOME = (20_000, 40_000)
# cuda vs cpu rebuild: params within atol 2 * ADAM_STEP * (the sum of the
# default schedule's lr over the run's steps; from the second epoch it is
# lr_min + lr) + REBUILD_RTOL |p|. Adam's first steps move a weight by about lr *
# sign(grad), and a gradient of rounding-noise size (the distance model's
# biases: the pairwise distances do not change when all embeddings move
# together) can round to opposite signs on the two devices at every step;
# over its first six steps a bias-corrected Adam step is at most 1.015 lr
# (Cauchy-Schwarz on the moment sums), hence ADAM_STEP. Embeddings within
# REBUILD_EMB_ATOL (those bias steps summed over 2,048 hidden units);
# distortions, which do not see a common shift, and class probabilities
# within the looser relative bounds of fp32 sums over 8,192 inputs
ADAM_STEP = 1.02
REBUILD_RTOL, REBUILD_EMB_ATOL = 1e-4, 2e-3
REBUILD_DIS_RTOL, REBUILD_DIS_ATOL = 1e-3, 1e-4
REBUILD_CLASS_RTOL, REBUILD_CLASS_ATOL = 1e-3, 1e-6
REBUILD_LOSS_RTOL = 1e-3
# FSW training at full width: R = 128 refreshes every 2-4 epochs on the
# backbone's subtrees of 27-45 batches, so 6 epochs refresh 2-3 times each
FSW_EPOCHS = 6
V_MAIN = canonical_vocab_size(K_MAIN)


def fsw_model_bytes(k: int) -> int:
    return 4 * (4 * FSW_BASE_DIM + FSW_OUT_DIM * (k * FSW_BASE_DIM + 1)
                + (FSW_OUT_DIM + 1) * HIDDEN_SIZE_FC1 + (HIDDEN_SIZE_FC1 + 1) * EMBEDDING_SIZE)


FSW_MODEL_BYTES = fsw_model_bytes(K_MAIN)
# short contigs of 1-2 kb hold at most ~2,000 k-mers at k=7, padded to at
# most 2,432 < V / 3: the per-genome route
CONTIGS, CONTIG_SIZE, CONTIG_LEN = 96, 48, (1_000, 2_000)


def fsw_routes(v: int) -> dict[str, tuple[str, ...]]:
    """The route lines each FSW training run logs once per subtree, at vocab
    size v."""
    shared = f"FSW shared-vocab path: V={v} (one shared sort per batch)"
    return {
        "lazy_shared": (shared, "FSW lazy sort-refresh path: refresh every 128 steps (auto-enabled; "
                                "pass -fsw_lazy_refresh 0 for the exact per-step sort)"),
        "exact_shared": (shared,),
        "lazy_pergenome": ("FSW lazy sort-refresh path (per-genome sort orders): refresh every 128 "
                           "steps (auto-enabled; pass -fsw_lazy_refresh 0 for the exact per-step "
                           "sort)",),
        "exact_pergenome": (),
    }


FSW_ROUTES = fsw_routes(V_MAIN)
# cuda vs cpu FSW training (2 subtrees of the small backbone, 2 epochs,
# default flags): params within the dense rebuild's Adam sign-flip bound;
# the exported embeddings within FSW_RTOL, the served FSW forward's
# tolerance, plus REBUILD_EMB_ATOL for those flips summed over 2,048 hidden
# units; distortions, which see no common shift, and best losses as in the
# dense rebuild
FSW_REBUILD_CLADES, FSW_REBUILD_EPOCHS = (0, 1), 2
PHASE5_TRAIN_SORT = (FSW_OUT_DIM, V_MAIN, 1)  # the exact shared step's one sort
UNSORT_SHAPES = ((FSW_OUT_DIM, V_MAIN), (16 * FSW_OUT_DIM, V_MAIN))
# chunk training at full width: get_chunks over the first CHUNK_PER_CLADE
# genomes (100-200 kb: 10-20 windows) of each subtree of the build's
# backbone; genomes, subtree sizes and epochs cut (2,000 / 8,000 by default)
CHUNK_PER_CLADE, CHUNK_EPOCHS = 64, 5
CHUNK_CPU_GENOMES = 4  # counted again with -device cpu
# a small chunk backbone trained on the card and on the CPU
CHUNK_RB_LEAVES, CHUNK_RB_SIZE, CHUNK_RB_EPOCHS = 24, 12, 2
CHUNK_RB_GENOME = (50_000, 80_000)
# more than 2^31 bases in one genome: a block repeated, counted in pieces
LONG_BLOCK, LONG_REPEATS = 1_000_000, 2_150
PHASE5_CHUNK_WINDOWS = 512  # one genome's 10 kb windows in one get_chunks launch
# host text: a build's .kf rows (1,700 genomes, V = 8,192) and a subtree's
# exported float32 rows (850 anchors, embedding 1,024)
TEXT_KF_ROWS, TEXT_F32_ROWS = 1700, 850
CLASSIFIER_BYTES = 4 * ((V_MAIN + 1) * HIDDEN_SIZE_FC1 + (HIDDEN_SIZE_FC1 + 1) * N_CLASSES)
DENSE_SUBTREE_BYTES = 4 * ((V_MAIN + 1) * HIDDEN_SIZE_FC1 + (HIDDEN_SIZE_FC1 + 1) * EMBEDDING_SIZE)
SERVE_TIMEOUT_S = 600  # the daemon's watchdog: a wedged request is answered, not waited on
# data-parallel training: 2 epochs of each trainer; a one-rank NCCL group
# against no group: bit for bit expected (one code path, whose one-rank sums
# are identities), held within rtol 1e-6
RANKS_EPOCHS, RANKS_W1_RTOL, RANKS_TIMEOUT_S = 2, 1e-6, 400
RANKS_DEVICE = "cuda"  # the ranks' -device (a CPU rehearsal sets "cpu")
# the model axis: the grid (1, 2), two ranks sharing the card over gloo, each
# with half the hidden units and half the FSW slices; its trainers are the
# ranks phase's (the same data, epochs and flags), held to that phase's runs
# without a group
MODEL_AXIS_GRID = (1, 2)
MODEL_AXIS_TRAINERS = ("train_classifier", "dense", "fsw_lazy", "fsw_exact")
# sort_rows at a rank's share of the slices: the exact shared step's and the
# lazy refresh's sort (256 rows of the vocab, one payload row) and a
# per-genome step's (16 genomes x 256 rows, one payload row per genome)
MODEL_AXIS_SORTS = ((FSW_OUT_DIM // 2, V_MAIN, 1), (16 * FSW_OUT_DIM // 2, V_MAIN, 16))
F32_TINY = float(np.finfo(np.float32).tiny)  # an atol under which only 0 matches 0
# FSW at k=8 (V = 32,896: every sort of its training and of its queries takes
# the cluster path) on the rebuild's small backbone: get_kmers, the
# classifier, default flags on every subtree (the CPU on FSW_REBUILD_CLADES),
# -fsw_lazy_refresh 0 on subtree 0, FSW_K8_EPOCHS epochs each
K8, FSW_K8_EPOCHS = 8, 2
V8 = canonical_vocab_size(K8)
# FSW at k=10 (V = 524,800) on a backbone of K10_LEAVES random genomes of
# 300-400 kb (1% N): each holds about 230,000-290,000 distinct canonical
# 10-mers, so every point set has CLUSTER_ELEMS < N < V and every sort of its
# training and queries takes the radix path; K10_QUERIES genomes queried
K10, FSW_K10_EPOCHS = 10, 2
V10 = canonical_vocab_size(K10)
K10_LEAVES, K10_SIZE, K10_GENOME, K10_QUERIES = 16, 8, (300_000, 400_000), 4
# the radix path's kernels in sort_rows.cu, which the traced k=10 epoch must hold
RADIX_KERNELS = ("radix_upsweep_kernel_digits", "radix_scan_kernel", "radix_downsweep_kernel")
# C6: one shared-route lazy refresh at k = 9 widths (V = 131,072, 512
# slices) of C6_ITEMS items in groups of pick_refresh_group's G
K9, C6_ITEMS = 9, 16
V9 = canonical_vocab_size(K9)
# FSW at k=9 (V = 131,072, upstream's largest canonical vocabulary) on one
# subtree of K9_LEAVES random genomes of 300-400 kb (1% N): each holds about
# 100,000-120,000 distinct canonical 9-mers, past V / 3, so the clade trains
# on the shared route, whose every sort of C x V takes sort_rows' cluster path
# and whose kernels read the weights from device memory (V is past the
# staging); K9_QUERIES genomes queried on the card and on the CPU
K9_LEAVES, K9_GENOME, K9_QUERIES, FSW_K9_EPOCHS = 8, (300_000, 400_000), 2, 2
# the lazy refresh of fsw_k9's subtree (850 items, 512 slices, V = 131,072),
# timed on random weights
K9_REFRESH_ITEMS = 850
# fsw_k9.train_exact's training chunk: a sort of 128 slices of the vocabulary
# (one weight row), and the coefficient kernels on its 16 items
K9_TRAIN_CHUNK = 128
# a measured device peak against a count: the caching allocator hands out a
# block up to 1 MiB larger than asked, and a stage holds a few dozen blocks
C5_ALLOC_SLACK = 64 << 20
# the zoo at kf2vec's default widths (the JAX package gives the zoo none of
# its own): V_MAIN inputs, HIDDEN_SIZE_FC1 hidden, EMBEDDING_SIZE out,
# N_CLASSES classes, BATCH_SIZE rows; the transformer's 16 heads and FFN of
# 2,048 (the reference's defaults), the BiRNN's 2 layers of EMBEDDING_SIZE
# over ZOO_WINDOWS windows. cuda vs cpu: fp32 sums over 8,192 inputs as the
# dense served models' tolerance; the transformer's softmax and LayerNorms
# and the LSTM's 16 recurrent steps compound more rounding
ZOO_HEADS, ZOO_FFN, ZOO_RNN_LAYERS, ZOO_WINDOWS = 16, 2048, 2, 16
ZOO_TIGHT, ZOO_LOOSE = (1e-4, 1e-5), (1e-3, 1e-4)


def log(msg: str) -> None:
    print(msg, flush=True)


def release_serving_caches() -> None:
    """Drop the models and anchors the serving caches keep on the card, so
    each phase's peak device memory and each process_query_data run start
    cold, as a one-shot process does."""
    clear_serving_caches()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def random_codes(rng, n: int, n_rate: float = 0.01, gc: float = 0.5) -> np.ndarray:
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
    codes = rng.choice(4, size=n, p=p).astype(np.uint8)
    codes[rng.random(n) < n_rate] = INVALID
    return codes


def to_batch(genomes: list[np.ndarray], device) -> tuple[torch.Tensor, torch.Tensor]:
    offsets = np.zeros(len(genomes) + 1, dtype=np.int64)
    np.cumsum([g.size for g in genomes], out=offsets[1:])
    bases = np.concatenate(genomes) if genomes else np.zeros(0, np.uint8)
    return torch.from_numpy(bases).to(device), torch.from_numpy(offsets).to(device)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


# -- phase 1 and 2 -------------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def phase_build() -> float:
    names = ["kmer_hist", "sort_rows", "lazy_refresh"]
    t0 = time.perf_counter()
    build.build_all(names)
    seconds = time.perf_counter() - t0
    for name in names:
        for line in build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"phase build: {', '.join(n + '.cu' for n in names)} with nvcc for sm_90a in "
        f"{seconds:.2f} s")
    t0 = time.perf_counter()
    how = "loaded, already built" if textio_lib.library_path().exists() else "built with g++"
    textio_lib.load()
    log(f"phase build: {textio_lib.SOURCE.name} (host text I/O) {how} in "
        f"{time.perf_counter() - t0:.2f} s")
    return seconds


# -- phase 3 -------------------------------------------------------------------


def edge_genomes(rng, k: int, tile: int) -> list[tuple[str, np.ndarray]]:
    lower = rng.choice(np.frombuffer(b"acgtnACGT", np.uint8), 300_000)
    repeat = np.concatenate([np.zeros(1_000_000, np.uint8), np.tile(np.array([0, 3], np.uint8), 500_000)])
    out = [
        ("random_1pctN", random_codes(rng, 1_500_000)),
        ("lowercase", encode_bases(lower)),
        ("multi_record", concat_with_separators(
            [random_codes(rng, 700_000), random_codes(rng, 5), random_codes(rng, 400_001)], k)),
        ("repeat_2Mb", repeat),
        ("empty", np.zeros(0, np.uint8)),
        ("shorter_than_k", random_codes(rng, k - 1, n_rate=0.0)),
    ]
    for m in (1, 3):  # windows = m tiles +- k, +-1, 0: the kernel's seam
        for d in (-k, -1, 0, 1, k):
            out.append((f"tile{m}{d:+d}", random_codes(rng, m * tile + d + k - 1, n_rate=0.001)))
    out.append(("big_9Mb", random_codes(rng, BIG_GENOME)))
    return out


def phase_kernel_vs_plain(dev) -> float:
    rng = np.random.default_rng(SEED)
    tile = tile_windows()
    max_err = 0.0
    for k in (3, 5, 7, 9, 12):
        genomes = edge_genomes(rng, k, tile)
        bases, offsets = to_batch([g for _, g in genomes], dev)
        got = kmer_hist(bases, offsets, k)
        torch.cuda.synchronize()
        ref = kmer_hist_reference(bases, offsets, k)
        max_err = max(max_err, float((got.long() - ref.long()).abs().max()))
        check(torch.equal(got, ref), f"k={k}: kernel != plain version")
        n_windows = sum(max(g.size - k + 1, 0) for _, g in genomes)
        if k == K_MAIN:
            host = got.cpu().numpy()
            for (name, g), row in zip(genomes, host):
                check(np.array_equal(row.astype(np.int64), count_canonical_numpy(g, k)),
                      f"k={k} {name}: kernel != count_canonical_numpy")
            # the 9 Mb genome alone: one genome per launch (the B2 route)
            big = genomes[-1][1]
            b1, o1 = to_batch([big], dev)
            alone = kmer_hist(b1, o1, k)
            check(torch.equal(alone[0], got[-1]), "9 Mb genome alone != in the batch")
        del got, ref, bases, offsets
        torch.cuda.empty_cache()
        log(f"phase kernel_vs_plain: k={k} G={len(genomes)} windows={n_windows} exact")
    return max_err


def sort_keys(kind: str, gen, r: int, n: int, dev) -> torch.Tensor:
    keys = torch.randn(r, n, generator=gen, device=dev)
    if kind == "ties_and_signed_zeros":  # rounded to 1 decimal: many exact ties, +-0.0
        keys = torch.round(keys * 10) / 10
        keys[torch.rand(r, n, generator=gen, device=dev) < 0.1] = -0.0
    elif kind == "sorted":
        keys = torch.sort(keys, dim=1).values
    elif kind == "reversed":
        keys = torch.sort(keys, dim=1, descending=True).values
    elif kind == "all_equal":
        keys = torch.full((r, n), 0.5, device=dev)
    elif kind == "signed_zeros":  # only -0.0 and +0.0
        keys = torch.where(keys < 0, -0.0, 0.0)
    elif kind == "top_bytes_shared":  # 1.0f's top three bytes, the low byte random
        low = torch.randint(0, 256, (r, n), generator=gen, device=dev, dtype=torch.int32)
        keys = (low | 0x3F800000).view(torch.float32)
    return keys.contiguous()


def check_sort(keys: torch.Tensor, payload: torch.Tensor, got, ref) -> int:
    """Fails unless the kernel's outputs are exact, ``perm`` equal to the
    plain (stable) version's on every row; returns the number of rows with
    tied keys, where an unstable sort could have differed."""
    (sk, sp, perm), (rk, _, rperm) = got, ref
    r, n = keys.shape
    check(torch.equal(sk.view(torch.int32), rk.view(torch.int32)), "sorted keys != plain version")
    p64 = perm.long()
    check(bool(((p64 >= 0) & (p64 < n)).all()), "perm out of range")
    ramp = torch.arange(n, dtype=torch.int32, device=keys.device).expand(r, n)
    check(torch.equal(torch.sort(perm, dim=1).values, ramp), "perm is not a permutation")
    check(torch.equal(torch.gather(keys, 1, p64).view(torch.int32), sk.view(torch.int32)),
          "keys[perm] != sorted keys")
    rows = torch.arange(r, device=keys.device) // (r // payload.shape[0])
    check(torch.equal(payload[rows[:, None], p64].view(torch.int32), sp.view(torch.int32)),
          "payload[perm] != sorted payload")
    check(torch.equal(perm, rperm), "perm != plain version")
    ints = rk.view(torch.int32)
    return int((ints[:, 1:] == ints[:, :-1]).any(dim=1).sum())


def phase_sort_vs_plain(dev) -> float:
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    check(tile_elems() == 16384 == TILE_ELEMS and cluster_elems() == 131072 == CLUSTER_ELEMS,
          f"tile of {tile_elems()} elements, cluster of {cluster_elems()} (the host's "
          f"TILE_ELEMS {TILE_ELEMS}, CLUSTER_ELEMS {CLUSTER_ELEMS})")
    max_err, cases = 0.0, 0
    for r in SORT_ROWS:
        for n in SORT_LENGTHS:
            tied = 0
            for p in sorted({r, r // 512} - {0}) if r % 512 == 0 else (r,):
                for kind in SORT_KINDS:
                    keys = sort_keys(kind, gen, r, n, dev)
                    payload = torch.rand(p, n, generator=gen, device=dev)
                    got = sort_rows(keys, payload)
                    torch.cuda.synchronize()
                    ref = sort_rows_reference(keys, payload)
                    tied += check_sort(keys, payload, got, ref)
                    finite = torch.isfinite(ref[0])
                    max_err = max(max_err, float((got[0] - ref[0])[finite].abs().max()))
                    cases += 1
                    del keys, payload, got, ref
            torch.cuda.empty_cache()
            log(f"phase sort_vs_plain: R={r} N={n} exact, perm equal on every row "
                f"({tied} rows with ties)")
    for r, n, p in MODEL_AXIS_SORTS:  # a model-axis rank's share of the slices
        keys = torch.randn(r, n, generator=gen, device=dev)
        payload = torch.rand(p, n, generator=gen, device=dev)
        got = sort_rows(keys, payload)
        torch.cuda.synchronize()
        ref = sort_rows_reference(keys, payload)
        check_sort(keys, payload, got, ref)
        max_err = max(max_err, float((got[0] - ref[0]).abs().max()))
        cases += 1
        log(f"phase sort_vs_plain: a model-axis rank's shape R={r} N={n} P={p} exact, perm "
            "equal on every row")
    for r in RADIX_SORT_ROWS:  # the radix path at k = 10's lengths
        for n in RADIX_SORT_LENGTHS:
            tied = 0
            for p in sorted({1, r}):
                for kind in SORT_KINDS:
                    keys = sort_keys(kind, gen, r, n, dev)
                    payload = torch.rand(p, n, generator=gen, device=dev)
                    before = sort_rows.long_launches, sort_rows.radix_launches
                    got = sort_rows(keys, payload)
                    torch.cuda.synchronize()
                    check((sort_rows.long_launches, sort_rows.radix_launches)
                          == (before[0], before[1] + 1),
                          f"R={r} N={n}: not counted on the radix path alone")
                    ref = sort_rows_reference(keys, payload)
                    tied += check_sort(keys, payload, got, ref)
                    max_err = max(max_err, float((got[0] - ref[0]).abs().max()))
                    cases += 1
                    del keys, payload, got, ref
            torch.cuda.empty_cache()
            log(f"phase sort_vs_plain: radix path R={r} N={n} exact, perm equal on every row "
                f"({tied} rows with ties)")
    r, n, kinds = RADIX_ADVERSARIAL
    radix_cases = ([(RADIX_SEAM_ROWS, m, kind) for m in RADIX_SEAM_LENGTHS
                    for kind in ("normal", "ties_and_signed_zeros")]
                   + [(RADIX_LONG_ROWS, RADIX_LONG_LENGTH, kind) for kind in SORT_KINDS]
                   + [(r, n, kind) for kind in kinds])
    for r, n, kind in radix_cases:  # the radix path's seams, a long row, adversarial keys
        keys = sort_keys(kind, gen, r, n, dev)
        payload_rows = sorted({1, r} | ({r // 3} if r % 3 == 0 else set()))
        for p in payload_rows:
            payload = torch.rand(p, n, generator=gen, device=dev)
            before = sort_rows.long_launches, sort_rows.radix_launches
            got = sort_rows(keys, payload)
            torch.cuda.synchronize()
            check((sort_rows.long_launches, sort_rows.radix_launches) == (before[0], before[1] + 1),
                  f"R={r} N={n}: not counted on the radix path alone")
            ref = sort_rows_reference(keys, payload)
            check_sort(keys, payload, got, ref)
            if kind == "all_equal":
                check(torch.equal(got[2], torch.arange(n, dtype=torch.int32, device=dev).expand(r, n)),
                      f"R={r} N={n}: all-equal keys, perm not the identity")
            max_err = max(max_err, float((got[0] - ref[0]).abs().max()))
            cases += 1
            del payload, got, ref
        del keys
        torch.cuda.empty_cache()
        log(f"phase sort_vs_plain: radix path R={r} N={n} {kind} keys exact at P in "
            f"{payload_rows}, perm equal on every row")
    log(f"phase sort_vs_plain: {cases} cases exact")
    return max_err


# -- phase 4 -------------------------------------------------------------------


def write_library(lib_dir: str, dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    v = canonical_vocab_size(K_MAIN)
    with torch.device(dev):
        classifier = init_params_(Classifier(v, HIDDEN_SIZE_FC1, N_CLASSES), gen)
    save_checkpoint(
        os.path.join(lib_dir, "classifier_model.ckpt"), "NeuralNetClassifierOnly",
        {"model_input_size": v, "model_hidden_size_fc1": HIDDEN_SIZE_FC1,
         "model_class_count": N_CLASSES},
        params_to_jax(classifier),
    )
    for c in range(N_CLASSES):
        with torch.device(dev):
            model = init_params_(DistEmbed(v, HIDDEN_SIZE_FC1, EMBEDDING_SIZE), gen)
        save_checkpoint(
            os.path.join(lib_dir, f"model_subtree_{c}.ckpt"), "NeuralNet",
            {"model_input_size": v, "model_hidden_size_fc1": HIDDEN_SIZE_FC1,
             "model_embedding_size": EMBEDDING_SIZE},
            params_to_jax(model),
        )
        anchors = torch.randn(N_ANCHORS, EMBEDDING_SIZE, generator=gen, device=dev)
        with open(os.path.join(lib_dir, f"embeddings_subtree_{c}.csv"), "w") as f:
            for i, row in enumerate(anchors.cpu().numpy().tolist()):
                f.write(f"c{c}_g{i}\t" + "\t".join(map(str, row)) + "\n")


def write_queries(q_dir: str) -> tuple[list[str], int]:
    """32 genomes of 1-6 Mb (one of 9 Mb), 1-3 records each, FASTA and
    FASTQ, GC content spread so the classes spread."""
    rng = np.random.default_rng(SEED + 1)
    names, total_bases = [], 0
    for i in range(N_QUERIES):
        total = BIG_GENOME if i == N_QUERIES - 1 else int(rng.integers(1_000_000, 6_000_001))
        n_rec = int(rng.integers(1, 4))
        cuts = np.sort(rng.integers(1, total, size=n_rec - 1)) if n_rec > 1 else np.zeros(0, int)
        seq = random_codes(rng, total, gc=0.3 + 0.4 * i / N_QUERIES)
        letters = np.frombuffer(b"ACGTN", np.uint8)[seq]
        records = np.split(letters, cuts)
        fastq = i % 2 == 1
        name = f"q{i:02d}"
        with open(os.path.join(q_dir, f"{name}.{'fastq' if fastq else 'fna'}"), "wb") as f:
            for j, rec in enumerate(records):
                body = rec.tobytes()
                if fastq:
                    f.write(b"@%s_%d\n%s\n+\n%s\n" % (name.encode(), j, body, b"I" * len(body)))
                else:
                    f.write(b">%s_%d\n%s\n" % (name.encode(), j, body))
        names.append(name)
        total_bases += total
    return names, total_bases


def read_table(path: str, header: bool = True) -> tuple[list[str], dict[str, np.ndarray]]:
    """(header cells, {label: values}) of a tab-separated table; `.emb`
    files have no header row."""
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t") if header else []
        rows = {}
        for line in f:
            parts = line.rstrip("\n").split("\t")
            rows[parts[0]] = np.array(parts[1:], dtype=np.float64)
    return header, rows


def check_outputs(out_dir: str, names: list[str], lib_dir: str, fsw_k: int | None,
                  n_classes: int = N_CLASSES) -> dict[str, int]:
    for ext in (".kf",) + ((f"_k{fsw_k}.npy",) if fsw_k else ()):
        got = sorted(f for f in os.listdir(out_dir) if f.endswith(ext))
        check(got == sorted(f"{n}{ext}" for n in names), f"expected {len(names)} {ext} files, got {len(got)}")
    header, classes = read_table(os.path.join(out_dir, "classes.out"))
    check(header[:3] == ["genome", "top_class", "top_p"] and len(header) == 3 + n_classes,
          "classes.out header")
    check(sorted(classes) == sorted(names), f"classes.out rows {len(classes)} != {len(names)}")
    top = {g: int(r[0]) for g, r in classes.items()}
    for g, r in classes.items():
        check(np.all(np.isfinite(r)) and abs(r[2:].sum() - 1) < 1e-4, f"{g}: class probabilities")
    for c in sorted(set(top.values())):
        h, dist = read_table(os.path.join(out_dir, f"apples_input_di_mtrx_subtree_{c}.csv"))
        with open(os.path.join(lib_dir, f"embeddings_subtree_{c}.csv")) as f:
            anchors = [line.split("\t", 1)[0] for line in f]
        check(h == [""] + anchors, f"subtree {c}: APPLES header != anchor names")
        members = sorted(g for g, cl in top.items() if cl == c)
        check(sorted(dist) == members, f"subtree {c}: APPLES rows")
        for g in members:
            check(dist[g].shape == (len(anchors),) and np.all(np.isfinite(dist[g]))
                  and np.all(dist[g] >= 0), f"subtree {c} {g}: APPLES values")
        _, emb = read_table(os.path.join(out_dir, f"embedding_subtree_{c}.emb"), header=False)
        check(sorted(emb) == members and all(
            e.shape == (EMBEDDING_SIZE,) and np.all(np.isfinite(e)) for e in emb.values()),
            f"subtree {c}: embeddings")
    return top


def write_fsw_library(fsw_dir: str, dense_dir: str, dev) -> int:
    """The dense library's classifier and 12 FSW subtree models with the
    JAX package's meta keys (train/distance.py:334-341); returns the bytes
    of one subtree model's parameters."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    shutil.copy(os.path.join(dense_dir, "classifier_model.ckpt"), fsw_dir)
    meta = {"model_input_size": K_MAIN + 1, "model_hidden_size_fc1": HIDDEN_SIZE_FC1,
            "model_embedding_size": EMBEDDING_SIZE, "fsw_k": K_MAIN,
            "fsw_base_dim": FSW_BASE_DIM, "fsw_out_dim": FSW_OUT_DIM}
    for c in range(N_CLASSES):
        with torch.device(dev):
            model = init_fsw_dist_embed_(FSWDistEmbed(
                K_MAIN, FSW_BASE_DIM, FSW_OUT_DIM, HIDDEN_SIZE_FC1, EMBEDDING_SIZE), gen)
        save_checkpoint(os.path.join(fsw_dir, f"model_subtree_{c}.ckpt"), "NeuralNetFSW", meta,
                        params_to_jax(model))
        anchors = torch.randn(N_ANCHORS, EMBEDDING_SIZE, generator=gen, device=dev)
        with open(os.path.join(fsw_dir, f"embeddings_subtree_{c}.csv"), "w") as f:
            for i, row in enumerate(anchors.cpu().numpy().tolist()):
                f.write(f"c{c}_g{i}\t" + "\t".join(map(str, row)) + "\n")
    return sum(4 * t.numel() for t in model.parameters())


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def counted(fn, *args):
    """fn(*args) with every launch count set to 0 just before it; returns
    its result and the counts just after (``sort_rows_long`` and
    ``sort_rows_radix``: the cluster and the radix path's launches among
    sort_rows')."""
    kmer_hist.launches = sort_rows.launches = sort_rows.long_launches = 0
    sort_rows.radix_launches = refresh_planes.launches = pergenome_planes.launches = 0
    exact_coefficients.launches = 0
    out = fn(*args)
    return out, {"kmer_hist": kmer_hist.launches, "sort_rows": sort_rows.launches,
                 "sort_rows_long": sort_rows.long_launches,
                 "sort_rows_radix": sort_rows.radix_launches,
                 "refresh_planes": refresh_planes.launches,
                 "pergenome_planes": pergenome_planes.launches,
                 "exact_coefficients": exact_coefficients.launches}


def serve_on_card(tag: str, work: str, lib_dir: str, q_dir: str, names: list[str],
                  model_bytes: int, fsw_k: int | None, n_classes: int = N_CLASSES,
                  k: int = K_MAIN) -> dict:
    """process_query_data on the card with every launch count set to 0 just
    before it; returns the output directory, the counts, the stage seconds
    and the peak device memory."""
    out_dir = os.path.join(work, f"out_{tag}_cuda")
    os.makedirs(out_dir)
    argv = ["process_query_data", "-input_dir", q_dir, "-output_dir", out_dir,
            "-k", str(k), "-classifier_model", lib_dir, "-distance_model", lib_dir]
    release_serving_caches()
    torch.cuda.reset_peak_memory_stats()
    stage_s, launches = counted(cli_main, argv)  # default device: the card
    peak = torch.cuda.max_memory_allocated()
    check(launches["kmer_hist"] >= 1, f"{tag}: kmer_hist was not launched on the main path")
    if fsw_k:
        check(launches["sort_rows"] >= 1, f"{tag}: sort_rows was not launched on the main path")
    check(peak >= model_bytes, f"{tag}: peak device memory {peak} B: the models did not run on the card")
    top = check_outputs(out_dir, names, lib_dir, fsw_k, n_classes)
    log(f"phase main_path {tag}: cuda run ok, launches={launches}, peak device memory "
        f"{peak / 2**20:.0f} MiB, classes used={sorted(set(top.values()))}, stage seconds {stage_s}")
    return {"out_dir": out_dir, "launches": launches, "stage_s": stage_s, "peak_mib": peak / 2**20}


def drive_path(tag: str, work: str, lib_dir: str, q_dir: str, names: list[str],
               model_bytes: int, fsw_k: int | None, n_classes: int = N_CLASSES,
               k: int = K_MAIN) -> dict:
    """serve_on_card, then 4 genomes again with -device cpu; returns the
    counts, the stage seconds and the largest cuda-vs-cpu differences."""
    run = serve_on_card(tag, work, lib_dir, q_dir, names, model_bytes, fsw_k, n_classes, k)
    out_dir, launches = run["out_dir"], run["launches"]

    # four genomes again on the CPU (one FASTQ, multi-record, the 9 Mb one)
    cpu_names = [names[0], names[1], names[2], names[-1]]
    q_cpu, out_cpu = os.path.join(work, f"queries_{tag}_cpu"), os.path.join(work, f"out_{tag}_cpu")
    os.makedirs(q_cpu)
    os.makedirs(out_cpu)
    for f in os.listdir(q_dir):
        if f.rsplit(".f", 1)[0] in cpu_names:
            os.symlink(os.path.join(q_dir, f), os.path.join(q_cpu, f))
    cli_main(["process_query_data", "-input_dir", q_cpu, "-output_dir", out_cpu,
              "-k", str(k), "-classifier_model", lib_dir, "-distance_model", lib_dir,
              "-device", "cpu"])
    check(kmer_hist.launches == launches["kmer_hist"] and sort_rows.launches == launches["sort_rows"],
          f"{tag}: the CPU run launched a CUDA kernel")
    for n in cpu_names:
        for f in [f"{n}.kf"] + ([f"{n}_k{fsw_k}.npy"] if fsw_k else []):
            check(read_bytes(os.path.join(out_dir, f)) == read_bytes(os.path.join(out_cpu, f)),
                  f"{f} differs between cuda and cpu")
    rtol, atol = (FSW_RTOL, FSW_ATOL) if fsw_k else (1e-4, 1e-5)
    _, cls_gpu = read_table(os.path.join(out_dir, "classes.out"))
    _, cls_cpu = read_table(os.path.join(out_cpu, "classes.out"))
    compared, diffs = 0, {"max_abs": 0.0, "max_rel": 0.0, "tolerance_used": 0.0}
    for n in cpu_names:
        np.testing.assert_allclose(cls_cpu[n][2:], cls_gpu[n][2:], rtol=1e-4, atol=1e-7)
        logp = np.sort(np.log(cls_gpu[n][2:]))
        if logp[-1] - logp[-2] <= 1e-3:
            log(f"  {n}: top two classes within 1e-3 in log-probability; top_class not compared")
            continue
        check(cls_cpu[n][0] == cls_gpu[n][0], f"{n}: top_class differs between cuda and cpu")
        c = int(cls_gpu[n][0])
        for kind, has_header in (("apples_input_di_mtrx_subtree_{}.csv", True),
                                 ("embedding_subtree_{}.emb", False)):
            _, a = read_table(os.path.join(out_dir, kind.format(c)), has_header)
            _, b = read_table(os.path.join(out_cpu, kind.format(c)), has_header)
            diff, ref = np.abs(a[n] - b[n]), np.abs(b[n])
            away = ref > atol  # relative differences of values near 0 say nothing
            diffs["max_abs"] = max(diffs["max_abs"], float(diff.max()))
            diffs["max_rel"] = max(diffs["max_rel"], float(np.max(diff[away] / ref[away], initial=0.0)))
            diffs["tolerance_used"] = max(diffs["tolerance_used"], float(np.max(diff / (atol + rtol * ref))))
            np.testing.assert_allclose(b[n], a[n], rtol=rtol, atol=atol)
        compared += 1
    check(compared >= 1, "no genome had a clear top class to compare cuda and cpu outputs")
    log(f"phase main_path {tag}: cpu rerun of {len(cpu_names)} genomes: .kf"
        f"{' and .npy' if fsw_k else ''} identical, classes within rtol 1e-4, APPLES/.emb of "
        f"{compared} genomes within rtol {rtol} / atol {atol}; largest differences "
        f"{json.dumps(diffs)} (max_rel over |value| > atol; tolerance_used = "
        f"max |a-b| / (atol + rtol |b|), at most 1)")
    return {**run, "cuda_vs_cpu": diffs}


def phase_main_paths(work: str, dev) -> tuple[dict[str, dict], str, list[str]]:
    lib_dir, fsw_dir, q_dir = (os.path.join(work, d) for d in ("library", "library_fsw", "queries"))
    for d in (lib_dir, fsw_dir, q_dir):
        os.makedirs(d)
    t0 = time.perf_counter()
    write_library(lib_dir, dev)
    fsw_bytes = write_fsw_library(fsw_dir, lib_dir, dev)
    names, total_bases = write_queries(q_dir)
    log(f"phase main_path: libraries + {len(names)} queries ({total_bases} bases) written in "
        f"{time.perf_counter() - t0:.1f} s")
    return {
        "dense": {**drive_path("dense", work, lib_dir, q_dir, names, DENSE_MODEL_BYTES, None),
                  "lib_dir": lib_dir, "subtree_bytes": DENSE_SUBTREE_BYTES},
        "fsw": {**drive_path("fsw", work, fsw_dir, q_dir, names, fsw_bytes, K_MAIN),
                "lib_dir": fsw_dir, "subtree_bytes": fsw_bytes},
    }, q_dir, names


# -- phase 4e: the serve daemon ---------------------------------------------------


class PipedDaemon:
    """An in-process ``ServeDaemon`` on the card, fed one JSON request at a
    time through an OS pipe, its replies read back through another. While
    its loop runs the daemon sends sys.stdout to stderr, so the caller logs
    nothing until ``close``."""

    def __init__(self, lib: str):
        self.daemon = ServeDaemon(build_parser().parse_args([
            "serve", "-classifier_model", lib, "-distance_model", lib, "-k", str(K_MAIN),
            "-request_timeout", str(SERVE_TIMEOUT_S)]))
        r_in, w_in = os.pipe()
        r_out, w_out = os.pipe()
        self._send, self._recv = os.fdopen(w_in, "w"), os.fdopen(r_out)
        self._thread = threading.Thread(
            target=self._loop, args=(os.fdopen(r_in), os.fdopen(w_out, "w")), daemon=True)
        self._thread.start()
        self.ready = self._reply()

    def _loop(self, stdin, stdout) -> None:
        with stdin, stdout:
            self.daemon.serve(stdin=stdin, stdout=stdout)

    def _reply(self) -> dict:
        line = self._recv.readline()
        check(line.endswith("\n"), "the daemon closed its reply pipe")
        return json.loads(line)  # every reply line is JSON

    def request(self, req: dict) -> dict:
        """One request, the launch counts set to 0 just before it: its reply,
        wall seconds and launches."""
        torch.cuda.synchronize()
        kmer_hist.launches = sort_rows.launches = 0
        t0 = time.perf_counter()
        self._send.write(json.dumps(req) + "\n")
        self._send.flush()
        reply = self._reply()
        return {"reply": reply, "wall_s": time.perf_counter() - t0,
                "launches": {"kmer_hist": kmer_hist.launches, "sort_rows": sort_rows.launches}}

    def close(self) -> dict:
        bye = self.request({"cmd": "quit"})
        self._thread.join(timeout=60)
        check(not self._thread.is_alive(), "the daemon did not stop after quit")
        self._send.close()
        self._recv.close()
        return bye


def same_or_close(d_serve: str, d_ref: str, rtol: float, atol: float) -> str:
    """APPLES and .emb files of a daemon run against process_query_data's:
    'identical' if every file's bytes are, else checked within rtol / atol
    and 'within tolerance'."""
    files = sorted(f for f in os.listdir(d_ref) if f.startswith(("apples_input", "embedding_subtree")))
    check(files and files == sorted(f for f in os.listdir(d_serve)
                                    if f.startswith(("apples_input", "embedding_subtree"))),
          f"{d_serve}: APPLES / .emb files differ from {d_ref}")
    if all(read_bytes(os.path.join(d_serve, f)) == read_bytes(os.path.join(d_ref, f)) for f in files):
        return "identical"
    for f in files:
        header = f.startswith("apples_input")
        h_a, a = read_table(os.path.join(d_serve, f), header)
        h_b, b = read_table(os.path.join(d_ref, f), header)
        check(h_a == h_b and list(a) == list(b), f"{f}: headers or rows differ")
        for g in a:
            np.testing.assert_allclose(a[g], b[g], rtol=rtol, atol=atol)
    return "within tolerance"


def serve_library(tag: str, work: str, run: dict, q_dir: str, names: list[str]) -> dict:
    """ping, warm, place on the 32 raw genomes, place_features on phase 4's
    features twice (stats around the second) and quit, through an
    in-process daemon on the card, from empty serving caches."""
    lib, fsw_k = run["lib_dir"], (K_MAIN if tag == "fsw" else None)
    release_serving_caches()
    torch.cuda.reset_peak_memory_stats()
    dirs = {step: os.path.join(work, f"serve_{tag}_{step}")
            for step in ("place", "place_features_1", "place_features_2")}
    t0 = time.perf_counter()
    daemon = PipedDaemon(lib)
    ready_s = time.perf_counter() - t0
    steps = {}
    try:
        steps["ping"] = daemon.request({"cmd": "ping"})
        steps["warm"] = daemon.request({"cmd": "warm"})
        steps["place"] = daemon.request({"cmd": "place", "input_dir": q_dir, "output_dir": dirs["place"]})
        for i in (1, 2):
            steps[f"stats_{i}"] = daemon.request({"cmd": "stats"})
            steps[f"place_features_{i}"] = daemon.request({
                "cmd": "place_features", "features_dir": run["out_dir"],
                "output_dir": dirs[f"place_features_{i}"]})
        steps["stats_3"] = daemon.request({"cmd": "stats"})
    finally:
        steps["quit"] = daemon.close()
    peak = torch.cuda.max_memory_allocated()
    replies = {step: r["reply"] for step, r in steps.items()}
    bad = {step: r for step, r in replies.items() if not r.get("ok")}
    check(not bad, f"serve {tag}: failed requests {bad}")
    check(daemon.ready.get("event") == "ready" and replies["ping"]["pong"] and replies["quit"]["bye"],
          f"serve {tag}: ready / ping / quit replies")
    library_bytes = CLASSIFIER_BYTES + N_CLASSES * run["subtree_bytes"]
    warm = replies["warm"]
    check(warm["models"] == 1 + N_CLASSES and warm["device_bytes"] >= library_bytes,
          f"serve {tag}: warm {warm} against {library_bytes} parameter bytes")
    launches = steps["place"]["launches"]
    check(launches["kmer_hist"] >= 1, f"serve {tag}: kmer_hist was not launched by place")
    if fsw_k:
        check(launches["sort_rows"] >= 1, f"serve {tag}: sort_rows was not launched by place")
    for kind in ("checkpoints", "anchors"):
        before, after = replies["stats_2"]["caches"][kind], replies["stats_3"]["caches"][kind]
        check(after["misses"] == before["misses"] and after["hits"] > before["hits"],
              f"serve {tag}: the second place_features' {kind}: {before} -> {after}")
    exts = (".kf",) + ((f"_k{fsw_k}.npy",) if fsw_k else ())
    for n in names:
        for f in [f"{n}{e}" for e in exts]:
            check(read_bytes(os.path.join(dirs["place"], f)) == read_bytes(os.path.join(run["out_dir"], f)),
                  f"serve {tag}: {f} differs from process_query_data's")
    rtol, atol = (FSW_RTOL, FSW_ATOL) if fsw_k else (1e-4, 1e-5)
    held = {}
    for step, d in dirs.items():
        check(read_bytes(os.path.join(d, "classes.out")) == read_bytes(os.path.join(run["out_dir"], "classes.out")),
              f"serve {tag} {step}: classes.out differs from process_query_data's")
        held[step] = same_or_close(d, run["out_dir"], rtol, atol)
    out = {"ready_s": ready_s, "peak_mib": peak / 2**20, "apples_emb": held,
           "cold_process_query_data_s": run["stage_s"]}
    for step in ("warm", "place", "place_features_1", "place_features_2"):
        r = replies[step]
        out[step] = {"wall_s": steps[step]["wall_s"], "launches": steps[step]["launches"],
                     **{key: r[key] for key in ("seconds", "phases_ms", "dispatches", "models",
                                                "compiled", "device_bytes") if key in r}}
    out["launches"] = {name: sum(steps[step]["launches"][name] for step in
                                 ("place", "place_features_1", "place_features_2"))
                       for name in ("kmer_hist", "sort_rows")}
    return out


def serve_cli(work: str, run: dict, q_dir: str) -> dict:
    """``python -m kf2vecfsw_tpu_torch serve ... -warm`` as a subprocess on
    the dense library: ping, place on the 32 raw genomes, quit. Its stdout
    must hold only JSON lines, and it must exit with 0."""
    lib, out_dir = run["lib_dir"], os.path.join(work, "serve_cli_place")
    err_path = os.path.join(work, "serve_cli.stderr")
    cmd = [sys.executable, "-m", "kf2vecfsw_tpu_torch", "serve", "-classifier_model", lib,
           "-distance_model", lib, "-k", str(K_MAIN), "-warm",
           "-request_timeout", str(SERVE_TIMEOUT_S)]
    replies, seconds = [], []
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), text=True,
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err)
        try:
            ready = json.loads(proc.stdout.readline())
            ready_s = time.perf_counter() - t0
            for req in ({"cmd": "ping"}, {"cmd": "place", "input_dir": q_dir, "output_dir": out_dir},
                        {"cmd": "quit"}):
                t1 = time.perf_counter()
                proc.stdin.write(json.dumps(req) + "\n")
                proc.stdin.flush()
                replies.append(json.loads(proc.stdout.readline()))
                seconds.append(time.perf_counter() - t1)
            rest, _ = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(err_path) as f:
        err_tail = f.read()[-2000:]
    check(proc.returncode == 0, f"serve CLI exit {proc.returncode}: {err_tail}")
    for line in rest.splitlines():
        json.loads(line)  # nothing but JSON on stdout
    check(ready.get("event") == "ready" and all(r.get("ok") for r in replies),
          f"serve CLI replies {ready} {replies}: {err_tail}")
    check(read_bytes(os.path.join(out_dir, "classes.out"))
          == read_bytes(os.path.join(run["out_dir"], "classes.out")),
          "serve CLI: classes.out differs from process_query_data's")
    return {"ready_s": ready_s, "ping_s": seconds[0], "place_s": seconds[1],
            "place_phases_ms": replies[1]["phases_ms"], "quit_s": seconds[2]}


def phase_serve(work: str, paths: dict, q_dir: str, names: list[str]) -> dict:
    """The serve daemon on phase 4's libraries and queries (see the module
    docstring, phase 4)."""
    out = {tag: serve_library(tag, work, run, q_dir, names) for tag, run in paths.items()}
    for tag, res in out.items():
        log(f"phase serve {tag}: {json.dumps(res)}")
    out["cli"] = serve_cli(work, paths["dense"], q_dir)
    log(f"phase serve cli: {json.dumps(out['cli'])}")
    release_serving_caches()
    return out


# -- phase 4b: build_library ------------------------------------------------------


def random_backbone(rng, n_leaves: int, prefix: str) -> tuple[str, dict[str, float]]:
    """A random binary tree on n_leaves (sequential leaf attachment) as newick
    text, with random edge lengths and support values on the internal nodes
    (so divide_tree's unit-length pre-pass covers every edge and -size is
    about the leaves per subtree), and each leaf's GC content, drifting from
    0.5 along the tree so that near leaves have near compositions."""
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
    names = {v: f"{prefix}{i:04d}" for i, v in enumerate(sorted(leaves))}
    gc: dict[str, float] = {}

    def text(v: int, g: float) -> str:
        g = float(np.clip(g + rng.normal(0.0, 0.03), 0.25, 0.75))
        length = f":{0.01 + 0.2 * rng.random():.6g}" if v else ""
        if v not in children:
            gc[names[v]] = g
            return names[v] + length
        support = str(int(rng.integers(50, 101))) if v else ""
        return "(" + ",".join(text(c, g) for c in children[v]) + ")" + support + length

    return text(0, 0.5) + ";", gc


def write_backbone(work: str, tag: str, rng, n_leaves: int, lengths: tuple[int, int]):
    """FASTA genomes (1% N) of a random backbone and the tree; returns the
    genome directory, the tree's text and the number of bases."""
    fna = os.path.join(work, f"{tag}_fna")
    os.makedirs(fna)
    nwk, gc = random_backbone(rng, n_leaves, tag)
    letters, total = np.frombuffer(b"ACGTN", np.uint8), 0
    for name, g in gc.items():
        n = int(rng.integers(lengths[0], lengths[1] + 1))
        with open(os.path.join(fna, f"{name}.fna"), "wb") as f:
            f.write(b">%s\n%s\n" % (name.encode(), letters[random_codes(rng, n, gc=g)].tobytes()))
        total += n
    return fna, nwk, total


def build_library(work: str, tag: str, fna: str, nwk: str, size: int, epochs: int,
                  device: str) -> tuple[str, str, dict]:
    """The port's build_library at full width; the tree goes into a fresh
    directory first, since the tree commands write next to it."""
    lib, tree_dir = os.path.join(work, f"lib_{tag}"), os.path.join(work, f"tree_{tag}")
    os.makedirs(lib)
    os.makedirs(tree_dir)
    tree = os.path.join(tree_dir, "tree.nwk")
    with open(tree, "w") as f:
        f.write(nwk)
    stage_s = cli_main(["build_library", "-input_dir", fna, "-output_dir", lib, "-tree", tree,
                        "-k", str(K_MAIN), "-size", str(size), "-cl_epochs", str(epochs),
                        "-di_epochs", str(epochs), "-device", device])
    return lib, tree_dir, stage_s


class TrainerClock:
    """Times a build_library run's trainers by wrapping module globals they
    call (restored on exit): each epoch (ended by a card synchronise, which
    costs nothing extra since the trainer fetches the epoch's loss right
    after), each export with its str(np.float32) formatting apart, and the
    host work around the epochs (.kf parsing, checkpoint writes, and the
    set-up of model copies and optimizer on the card, which pays for
    torch's first optimizer use). FSW runs add their lazy epochs, each
    lazy refresh between two card synchronises (with the index of the
    epoch it fell in) and the exports' ``sort_rows`` launches; the chunk
    trainers, their epochs, exports, `.kf` parsing and store builds."""

    def __init__(self):
        self.epochs: dict[str, list[tuple[int, float]]] = {"classifier": [], "distance": []}
        self.exports: list[dict] = []
        self.host_s: dict[str, float] = {}
        self.refresh_s: list[tuple[int, float]] = []
        self._format_s = 0.0
        self._saved = []

    def __enter__(self):
        for mod, name, wrap in (
                (train_classifier, "classifier_epoch", self._epoch("classifier")),
                (train_distance, "distance_epoch", self._epoch("distance")),
                (train_distance, "lazy_distance_epoch", self._epoch("distance")),
                (fsw_lazy.LazyPlanes, "refresh", self._refresh),
                (train_distance, "export_embeddings", self._export),
                (train_distance, "f32_row", self._format),
                (train_classifier, "load_kf_matrix", self._host("classifier .kf parse")),
                (train_distance, "load_kf_matrix", self._host("distance .kf parse")),
                (train_classifier, "save_checkpoint", self._host("classifier checkpoint write")),
                (train_distance, "save_checkpoint", self._host("distance checkpoint write")),
                (train_classifier, "start_or_resume", self._host("classifier set-up")),
                (train_distance, "start_or_resume", self._host("distance set-up")),
                (train_chunks, "chunk_classifier_epoch", self._epoch("classifier")),
                (train_chunks, "chunk_distance_epoch", self._epoch("distance")),
                (train_chunks, "export_embeddings", self._export),
                (train_chunks, "load_kf_matrix", self._host("chunk full-genome .kf parse")),
                (train_chunks.ChunkStore, "__init__", self._host("chunk .kf parse")),
                (train_chunks.DeviceChunkStore, "__init__", self._host("device store build")),
                (train_chunks, "save_checkpoint", self._host("chunk checkpoint write")),
                (train_chunks, "start_or_resume", self._host("chunk set-up"))):
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, wrap(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def _epoch(self, kind: str):
        def wrap(fn):
            def timed(model, opt, feats, target, order, batch_size, *args, **kw):
                t0 = time.perf_counter()
                out = fn(model, opt, feats, target, order, batch_size, *args, **kw)
                if torch.cuda.is_available():  # a CPU rehearsal of the ranks has no card
                    torch.cuda.synchronize()
                self.epochs[kind].append((-(-order.numel() // batch_size), time.perf_counter() - t0))
                return out
            return timed
        return wrap

    def _export(self, fn):
        def timed(model, feats, names, *args, **kw):
            self._format_s = 0.0
            launches = sort_rows.launches, exact_coefficients.launches
            t0 = time.perf_counter()
            out = fn(model, feats, names, *args, **kw)
            self.exports.append({"rows": len(names), "s": time.perf_counter() - t0,
                                 "format_s": self._format_s,
                                 "sort_rows": sort_rows.launches - launches[0],
                                 "exact_coefficients": exact_coefficients.launches - launches[1]})
            return out
        return timed

    def _refresh(self, fn):
        def timed(planes, model):
            card = torch.cuda.is_available()  # a CPU rehearsal of the ranks has no card
            if card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(planes, model)
            if card:
                torch.cuda.synchronize()
            self.refresh_s.append((len(self.epochs["distance"]), time.perf_counter() - t0))
            return out
        return timed

    def _format(self, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self._format_s += time.perf_counter() - t0
            return out
        return timed

    def _host(self, key: str):
        def wrap(fn):
            def timed(*args, **kw):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                self.host_s[key] = self.host_s.get(key, 0.0) + time.perf_counter() - t0
                return out
            return timed
        return wrap

    def steps_per_s(self, kind: str, epochs: int, without_refresh: bool = False) -> float:
        """Steps per second over epochs 2 to `epochs` of every run of a trainer
        (the first epoch of each run pays for first-call set-up), with or
        without the lazy refreshes that fell in those epochs."""
        later = [i for i in range(len(self.epochs[kind])) if i % epochs]
        seconds = sum(self.epochs[kind][i][1] for i in later)
        if without_refresh:
            seconds -= sum(s for i, s in self.refresh_s if i % epochs)
        return sum(self.epochs[kind][i][0] for i in later) / seconds


def read_subtree_rows(tree_dir: str) -> dict[str, int]:
    with open(os.path.join(tree_dir, "tree.subtrees")) as f:
        f.readline()
        return {g: int(c) for g, c in (line.split() for line in f if line.strip())}


def check_library(lib: str, clades: dict[str, int], n_genomes: int) -> None:
    """Every file of a trained dense library, with finite values of the
    expected shapes, and no NaN loss in the run logs."""
    check(len([f for f in os.listdir(lib) if f.endswith(".kf")]) == n_genomes, ".kf files")
    n_classes = len(set(clades.values()))
    header, rows = read_table(os.path.join(lib, "backbone_classes.out"))
    check(header[:4] == ["genome", "true_class", "top_class", "top_p"]
          and len(header) == 4 + n_classes and len(rows) == len(clades), "backbone_classes.out")
    check(all(np.all(np.isfinite(r)) and int(r[0]) == clades[g] for g, r in rows.items()),
          "backbone_classes.out values")
    _, meta, _ = load_checkpoint(os.path.join(lib, "classifier_model.ckpt"))
    check(np.isfinite(meta["lowest_loss"]), f"classifier: lowest loss {meta['lowest_loss']}")
    check_subtree_models(lib, clades, "NeuralNet")


def check_subtree_models(lib: str, clades: dict[str, int], family: str, k: int = K_MAIN) -> None:
    """Each subtree's checkpoint (family, finite best loss; an FSW model's
    meta and parameter shapes at full width), embeddings and distortions of
    every member, and no NaN loss in the run logs."""
    for c in sorted(set(clades.values())):
        members = sorted(g for g, cl in clades.items() if cl == c)
        _, emb = read_table(os.path.join(lib, f"embeddings_subtree_{c}.csv"), header=False)
        check(sorted(emb) == members and all(e.shape == (EMBEDDING_SIZE,) and np.all(np.isfinite(e))
                                             for e in emb.values()), f"subtree {c}: embeddings")
        h, dis = read_table(os.path.join(lib, f"distortions_subtree_{c}.csv"))
        d = np.array([dis[g] for g in h[1:]])
        check(d.shape == (len(members),) * 2 and np.all(np.isfinite(d)) and np.all(d >= 0)
              and np.all(np.diag(d) == 0), f"subtree {c}: distortions")
        name, meta, params = load_checkpoint(os.path.join(lib, f"model_subtree_{c}.ckpt"))
        check(name == family and np.isfinite(meta["lowest_loss"]),
              f"subtree {c}: {name}, lowest loss {meta['lowest_loss']}")
        if family == "NeuralNetFSW":
            check((meta["fsw_k"], meta["fsw_base_dim"], meta["fsw_out_dim"])
                  == (k, FSW_BASE_DIM, FSW_OUT_DIM), f"subtree {c}: FSW meta {meta}")
            shapes = {"lookup": (4, FSW_BASE_DIM), "fsw/slices": (FSW_OUT_DIM, k * FSW_BASE_DIM),
                      "fsw/freqs": (FSW_OUT_DIM,), "fc1/w": (FSW_OUT_DIM, HIDDEN_SIZE_FC1),
                      "fc2/w": (HIDDEN_SIZE_FC1, EMBEDDING_SIZE)}
            for path, shape in shapes.items():
                leaf = params
                for key in path.split("/"):
                    leaf = leaf[key]
                check(np.shape(leaf) == shape and np.all(np.isfinite(leaf)),
                      f"subtree {c}: {path} {np.shape(leaf)}")
    for path in (os.path.join(lib, f) for f in os.listdir(lib) if f.endswith(".log")):
        with open(path) as f:
            text = f.read()
        losses = [float(v) for v in re.findall(r"Train loss: ([^,\s]+)", text)]
        check(losses and all(math.isfinite(v) for v in losses) and "Loss: nan" not in text,
              f"{os.path.basename(path)}: a loss is not finite")


def same_files(d_gpu: str, d_cpu: str, exts: tuple[str, ...]) -> None:
    files = sorted(f for f in os.listdir(d_cpu) if f.endswith(exts))
    check(files and files == sorted(f for f in os.listdir(d_gpu) if f.endswith(exts)),
          f"{exts} files")
    for f in files:
        check(read_bytes(os.path.join(d_gpu, f)) == read_bytes(os.path.join(d_cpu, f)),
              f"{f} differs between cuda and cpu")


class Tolerances:
    """The largest share of its tolerance, max |a-b| / (atol + rtol |b|),
    and the largest difference of each compared quantity."""

    def __init__(self):
        self.used: dict[str, float] = {}

    def compare(self, what: str, a: np.ndarray, b: np.ndarray, rtol: float, atol: float) -> None:
        check(a.shape == b.shape, f"{what}: shapes {a.shape} {b.shape}")
        diff = np.abs(a - b)
        self.used[what] = max(self.used.get(what, 0.0),
                              float(np.max(diff / (atol + rtol * np.abs(b)), initial=0.0)))
        self.used[f"{what} max_abs"] = max(self.used.get(f"{what} max_abs", 0.0),
                                           float(diff.max(initial=0.0)))

    def subtree_models(self, lib_gpu: str, lib_cpu: str, batches: dict[int, int], epochs: int,
                       emb_rtol: float) -> None:
        """Best losses, params (the Adam sign-flip bound over the run's
        steps), embeddings and distortions of the subtree models."""
        for c, n_batches in sorted(batches.items()):
            _, m_gpu, p_gpu = load_checkpoint(os.path.join(lib_gpu, f"model_subtree_{c}.ckpt"))
            _, m_cpu, p_cpu = load_checkpoint(os.path.join(lib_cpu, f"model_subtree_{c}.ckpt"))
            self.compare("lowest_loss", np.array([m_gpu["lowest_loss"]]),
                         np.array([m_cpu["lowest_loss"]]), REBUILD_LOSS_RTOL, 0.0)
            self.params(p_gpu, p_cpu, adam_drift(n_batches, epochs))
            for kind, has_header, rtol, atol in (
                    ("embeddings", False, emb_rtol, REBUILD_EMB_ATOL),
                    ("distortions", True, REBUILD_DIS_RTOL, REBUILD_DIS_ATOL)):
                _, a = read_table(os.path.join(lib_gpu, f"{kind}_subtree_{c}.csv"), has_header)
                _, b = read_table(os.path.join(lib_cpu, f"{kind}_subtree_{c}.csv"), has_header)
                check(sorted(a) == sorted(b), f"{kind}_subtree_{c}: rows")
                self.compare(kind, np.array([a[g] for g in sorted(a)]),
                             np.array([b[g] for g in sorted(b)]), rtol, atol)

    def params(self, p_gpu: dict, p_cpu: dict, atol: float) -> None:
        for key in p_cpu:
            if isinstance(p_cpu[key], dict):
                self.params(p_gpu[key], p_cpu[key], atol)
            else:
                self.compare("params", p_gpu[key], p_cpu[key], REBUILD_RTOL, atol)

    def check_all(self, what: str) -> None:
        for key, u in self.used.items():
            check("max_abs" in key or u <= 1.0, f"{what}: {key} outside its tolerance ({u})")


def adam_drift(n_batches: int, epochs: int) -> float:
    """The Adam sign-flip bound on a weight's cuda-vs-cpu difference after
    `epochs` epochs of `n_batches` steps at the default lr schedule."""
    return 2 * ADAM_STEP * n_batches * sum(
        step_lr(e, LEARNING_RATE, LEARNING_RATE_MIN, LEARNING_RATE_DECAY) for e in range(epochs))


def clade_batches(clades: dict[str, int], only=None) -> dict[int, int]:
    return {c: -(-sum(cl == c for cl in clades.values()) // BATCH_SIZE)
            for c in set(clades.values()) if only is None or c in only}


def compare_rebuilds(work: str) -> tuple[dict, str, str]:
    """The small backbone built on the card and on the CPU with the same seed:
    `.kf`, `.subtrees` and `.di_mtrx` bytes identical; checkpoints, classes
    and the exported CSVs within REBUILD_* tolerances (the largest
    differences are printed before they are checked). Returns the
    tolerances used, the genomes' directory and the tree's."""
    rng = np.random.default_rng(SEED + 40)
    fna, nwk, _ = write_backbone(work, "rb", rng, REBUILD_LEAVES, REBUILD_GENOME)
    built = {dev: build_library(work, f"rebuild_{dev}", fna, nwk, REBUILD_SIZE, REBUILD_EPOCHS,
                                dev) for dev in ("cuda", "cpu")}
    (lib_gpu, tree_gpu, _), (lib_cpu, tree_cpu, _) = built["cuda"], built["cpu"]
    same_files(lib_gpu, lib_cpu, (".kf",))
    same_files(tree_gpu, tree_cpu, (".subtrees", ".di_mtrx"))
    clades = read_subtree_rows(tree_cpu)
    tol = Tolerances()
    _, m_gpu, p_gpu = load_checkpoint(os.path.join(lib_gpu, "classifier_model.ckpt"))
    _, m_cpu, p_cpu = load_checkpoint(os.path.join(lib_cpu, "classifier_model.ckpt"))
    tol.compare("lowest_loss", np.array([m_gpu["lowest_loss"]]), np.array([m_cpu["lowest_loss"]]),
                REBUILD_LOSS_RTOL, 0.0)
    tol.params(p_gpu, p_cpu, adam_drift(-(-len(clades) // BATCH_SIZE), REBUILD_EPOCHS))
    tol.subtree_models(lib_gpu, lib_cpu, clade_batches(clades), REBUILD_EPOCHS, REBUILD_RTOL)
    _, cls_gpu = read_table(os.path.join(lib_gpu, "backbone_classes.out"))
    _, cls_cpu = read_table(os.path.join(lib_cpu, "backbone_classes.out"))
    for g in clades:
        tol.compare("classes", cls_gpu[g][2:], cls_cpu[g][2:], REBUILD_CLASS_RTOL,
                    REBUILD_CLASS_ATOL)
    log(f"phase build_library: rebuild of {REBUILD_LEAVES} genomes, -size {REBUILD_SIZE}, "
        f"{REBUILD_EPOCHS} epochs, cuda vs cpu: .kf/.subtrees/.di_mtrx identical; tolerance "
        f"used (max |a-b| / (atol + rtol |b|), at most 1) and largest differences "
        f"{json.dumps(tol.used)}")
    tol.check_all("rebuild cuda vs cpu")
    return tol.used, fna, tree_gpu


def phase_build_library(work: str, q_dir: str, q_names: list[str]) -> tuple[dict, dict]:
    """The build phase's numbers, and the paths the FSW training phase
    reuses: the backbone's genomes, tree directory and library, and the
    small backbone's genomes and tree directory."""
    rng = np.random.default_rng(SEED + 30)
    t0 = time.perf_counter()
    fna, nwk, total = write_backbone(work, "bb", rng, BUILD_LEAVES, BUILD_GENOME)
    log(f"phase build_library: backbone of {BUILD_LEAVES} genomes ({total} bases) written in "
        f"{time.perf_counter() - t0:.1f} s")
    release_serving_caches()
    torch.cuda.reset_peak_memory_stats()
    kmer_hist.launches = sort_rows.launches = 0
    with TrainerClock() as clock:
        lib, tree_dir, stage_s = build_library(work, "bb", fna, nwk, BUILD_SIZE, BUILD_EPOCHS, "cuda")
    launches = {"kmer_hist": kmer_hist.launches, "sort_rows": sort_rows.launches}
    peak = torch.cuda.max_memory_allocated()
    check(launches["kmer_hist"] >= 1, "build_library: kmer_hist was not launched")
    check(peak >= 2 * DENSE_MODEL_BYTES, f"build_library: peak device memory {peak} B")
    clades = read_subtree_rows(tree_dir)
    sizes = [sum(c == k for c in clades.values()) for k in sorted(set(clades.values()))]
    check(len(sizes) >= 2 and sum(sizes) == BUILD_LEAVES,
          f"divide_tree made {len(sizes)} subtrees of {sizes} genomes")
    check_library(lib, clades, BUILD_LEAVES)
    out = {"stage_s": stage_s, "launches": launches, "peak_mib": peak / 2**20,
           "subtree_sizes": sizes,
           "steps_per_s": {kind: clock.steps_per_s(kind, BUILD_EPOCHS) for kind in clock.epochs},
           "epoch_s": {kind: [t for _, t in runs] for kind, runs in clock.epochs.items()},
           "exports": clock.exports, "host_s": clock.host_s}
    log(f"phase build_library: cuda run ok, {json.dumps(out)}")
    serve = serve_on_card("trained", work, lib, q_dir, q_names, DENSE_MODEL_BYTES, None,
                          n_classes=len(sizes))
    out["serve"] = {"stage_s": serve["stage_s"], "launches": serve["launches"]}
    out["rebuild_tolerance_used"], rb_fna, rb_tree = compare_rebuilds(work)
    return out, {"fna": fna, "tree_dir": tree_dir, "lib": lib, "rb_fna": rb_fna,
                 "rb_tree_dir": rb_tree}


# -- phase 4c: FSW training -------------------------------------------------------


def route_lines(out_dir: str) -> list[str]:
    lines = []
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("train_model_") and name.endswith(".log"):
            with open(os.path.join(out_dir, name)) as f:
                lines += [line[line.index("FSW "):].rstrip("\n") for line in f if "FSW " in line]
    return lines


def train_fsw(route: str, feats: str, tree_dir: str, out_dir: str, n_clades: int,
              *flags: str) -> dict:
    """FSW train_model_set on the card at the default widths and learning
    rates for FSW_EPOCHS epochs, with every launch count set to 0 just
    before it; checks its route lines (FSW_ROUTES, once per subtree) and
    that sort_rows launched outside the exports; returns its launches,
    seconds, steps/s, refreshes and peak device memory."""
    os.makedirs(out_dir)
    release_serving_caches()
    torch.cuda.reset_peak_memory_stats()
    kmer_hist.launches = sort_rows.launches = refresh_planes.launches = 0
    pergenome_planes.launches = exact_coefficients.launches = 0
    t0 = time.perf_counter()
    with TrainerClock() as clock:
        cli_main(["train_model_set", "-input_dir", feats, "-subtrees",
                  os.path.join(tree_dir, "tree.subtrees"), "-true_dist", tree_dir, "-o", out_dir,
                  "-e", str(FSW_EPOCHS), *flags])
    seconds = time.perf_counter() - t0
    launches = {"kmer_hist": kmer_hist.launches, "sort_rows": sort_rows.launches,
                "refresh_planes": refresh_planes.launches,
                "pergenome_planes": pergenome_planes.launches,
                "exact_coefficients": exact_coefficients.launches}
    peak = torch.cuda.max_memory_allocated()
    lines = route_lines(out_dir)
    check(lines == list(FSW_ROUTES[route]) * n_clades,
          f"{route}: route lines {lines}, expected {FSW_ROUTES[route]} x {n_clades}")
    export_launches = sum(e["sort_rows"] for e in clock.exports)
    out = {
        "seconds": seconds, "launches": launches,
        "launches_outside_exports": launches["sort_rows"] - export_launches,
        "export_launches": export_launches,
        "steps": sum(n for n, _ in clock.epochs["distance"]),
        "steps_per_s": clock.steps_per_s("distance", FSW_EPOCHS),
        "steps_per_s_without_refresh": clock.steps_per_s("distance", FSW_EPOCHS, True),
        "refreshes": len(clock.refresh_s), "refresh_s": [s for _, s in clock.refresh_s],
        "epoch_s": [t for _, t in clock.epochs["distance"]],
        "exports": clock.exports, "peak_mib": peak / 2**20,
    }
    check(out["launches_outside_exports"] >= 1, f"{route}: sort_rows did not launch in training")
    check(("lazy" in route) == (out["refreshes"] > 0), f"{route}: {out['refreshes']} refreshes")
    check(launches["refresh_planes"] == (out["refreshes"] if route == "lazy_shared" else 0),
          f"{route}: refresh_planes launched {launches['refresh_planes']} times over "
          f"{out['refreshes']} refreshes")
    check(pergenome_launches_fit(route, launches, out["refreshes"]),
          f"{route}: pergenome_planes launched {launches['pergenome_planes']} times over "
          f"{out['refreshes']} refreshes")
    check(exact_launches_fit(route, launches, clock.exports, out["steps"]),
          f"{route}: exact_coefficients launched {launches['exact_coefficients']} times over "
          f"{out['steps']} steps and the exports {clock.exports}")
    check(peak >= 2 * FSW_MODEL_BYTES, f"{route}: peak device memory {peak} B")
    log(f"phase train_fsw {route}: {json.dumps(out)}")
    return out


def pergenome_launches_fit(route: str, launches: dict, refreshes: int) -> bool:
    """The per-genome planes kernel launches at least once a refresh (once a
    refresh group) on the lazy per-genome route, and never elsewhere."""
    if route == "lazy_pergenome":
        return launches["pergenome_planes"] >= refreshes > 0
    return launches["pergenome_planes"] == 0


def exact_launches_fit(route: str, launches: dict, exports: list[dict], steps: int) -> bool:
    """The exact coefficients launch once a sort in every export's forward
    and, in training, at least twice a step (forward and backward, three
    times a chunk where the slices are chunked) on an exact route, never on
    a lazy one."""
    in_exports = sum(e["exact_coefficients"] for e in exports)
    if any(e["exact_coefficients"] != e["sort_rows"] for e in exports):
        return False
    outside = launches["exact_coefficients"] - in_exports
    return outside >= 2 * steps if route.startswith("exact") else outside == 0


def divided_backbone(work: str, tag: str, seed: int, n_leaves: int, lengths: tuple[int, int],
                     size: int) -> tuple[str, str]:
    """The genomes of a random tree, divided into subtrees of `size` with
    their distance matrices; returns the genomes' directory and the tree's."""
    fna, nwk, _ = write_backbone(work, tag, np.random.default_rng(seed), n_leaves, lengths)
    tree_dir = os.path.join(work, f"tree_{tag}")
    os.makedirs(tree_dir)
    tree = os.path.join(tree_dir, "tree.nwk")
    with open(tree, "w") as f:
        f.write(nwk)
    cli_main(["divide_tree", "-tree", tree, "-size", str(size)])
    cli_main(["get_distances", "-tree", tree, "-subtrees",
              os.path.join(tree_dir, "tree.subtrees"), "-mode", "subtrees_only"])
    return fna, tree_dir


def contig_backbone(work: str) -> tuple[str, str]:
    """Short contigs of a random tree in subtrees of CONTIG_SIZE."""
    return divided_backbone(work, "ct", SEED + 50, CONTIGS, CONTIG_LEN, CONTIG_SIZE)


def get_kmers_on_card(fna: str, out_dir: str, n_genomes: int) -> int:
    """get_kmers at k=7 on the card, launch counts from 0; returns the
    kmer_hist launches."""
    kmer_hist.launches = sort_rows.launches = 0
    cli_main(["get_kmers", "-input_dir", fna, "-output_dir", out_dir, "-k", str(K_MAIN)])
    check(kmer_hist.launches >= 1, f"get_kmers {fna}: kmer_hist was not launched")
    check(len([f for f in os.listdir(out_dir) if f.endswith(f"_k{K_MAIN}.npy")]) == n_genomes,
          f"get_kmers {fna}: .npy files")
    return kmer_hist.launches


def compare_fsw_rebuilds(work: str, fna: str, tree_dir: str) -> dict:
    """The small backbone's .npy point sets from get_kmers on the card and
    on the CPU (bytes identical), then FSW training with default flags on
    FSW_REBUILD_CLADES for FSW_REBUILD_EPOCHS epochs on each device from the
    card's point sets; checkpoints and exports within the FSW_REBUILD_*
    tolerances."""
    clades = read_subtree_rows(tree_dir)
    feats = {}
    for dev in ("cuda", "cpu"):
        feats[dev] = os.path.join(work, f"rb_k7_{dev}")
        cli_main(["get_kmers", "-input_dir", fna, "-output_dir", feats[dev], "-k", str(K_MAIN),
                  "-device", dev])
    same_files(feats["cuda"], feats["cpu"], (".npy",))
    libs = {}
    for dev in ("cuda", "cpu"):
        libs[dev] = os.path.join(work, f"lib_fsw_rb_{dev}")
        os.makedirs(libs[dev])
        cli_main(["train_model_set", "-input_dir", feats["cuda"], "-subtrees",
                  os.path.join(tree_dir, "tree.subtrees"), "-true_dist", tree_dir,
                  "-o", libs[dev], "-e", str(FSW_REBUILD_EPOCHS), "-clade",
                  *map(str, FSW_REBUILD_CLADES), "-device", dev])
        check(route_lines(libs[dev]) == list(FSW_ROUTES["lazy_shared"]) * len(FSW_REBUILD_CLADES),
              f"{dev}: FSW rebuild route lines {route_lines(libs[dev])}")
    tol = Tolerances()
    tol.subtree_models(libs["cuda"], libs["cpu"], clade_batches(clades, FSW_REBUILD_CLADES),
                       FSW_REBUILD_EPOCHS, FSW_RTOL)
    log(f"phase train_fsw: rebuild of subtrees {FSW_REBUILD_CLADES} of the {REBUILD_LEAVES}-genome "
        f"backbone, {FSW_REBUILD_EPOCHS} epochs, default flags, cuda vs cpu: .npy identical; "
        f"tolerance used (max |a-b| / (atol + rtol |b|), at most 1) and largest differences "
        f"{json.dumps(tol.used)}")
    tol.check_all("FSW rebuild cuda vs cpu")
    return tol.used


def phase_train_fsw(work: str, paths: dict, q_dir: str, q_names: list[str]) -> dict:
    """FSW training on the card (see the module docstring, phase 4)."""
    clades = read_subtree_rows(paths["tree_dir"])
    sizes = {c: sum(cl == c for cl in clades.values()) for c in set(clades.values())}
    feats = os.path.join(work, "bb_k7")
    t0 = time.perf_counter()
    kmer_launches = get_kmers_on_card(paths["fna"], feats, len(clades))
    out = {"get_kmers_s": time.perf_counter() - t0, "routes": {}}
    lib_fsw = os.path.join(work, "lib_fsw")
    runs = out["routes"]
    runs["lazy_shared"] = train_fsw("lazy_shared", feats, paths["tree_dir"], lib_fsw, len(sizes))
    check_subtree_models(lib_fsw, clades, "NeuralNetFSW")
    smallest = min(sizes, key=sizes.get)
    exact_dir = os.path.join(work, "lib_fsw_exact")
    runs["exact_shared"] = train_fsw("exact_shared", feats, paths["tree_dir"], exact_dir, 1,
                                     "-fsw_lazy_refresh", "0", "-clade", str(smallest))
    check_subtree_models(exact_dir, {g: c for g, c in clades.items() if c == smallest},
                         "NeuralNetFSW")

    ct_fna, ct_tree = contig_backbone(work)
    ct_clades = read_subtree_rows(ct_tree)
    ct_feats = os.path.join(work, "ct_k7")
    kmer_launches += get_kmers_on_card(ct_fna, ct_feats, CONTIGS)
    longest = max(np.load(os.path.join(ct_feats, f), mmap_mode="r").shape[0]
                  for f in os.listdir(ct_feats))
    padded = bucket_items(longest, floor=128)
    check(V_MAIN > 3 * padded, f"contigs of {longest} k-mers pad to {padded}: not per-genome")
    n_ct = len(set(ct_clades.values()))
    for route, flags in (("lazy_pergenome", ()), ("exact_pergenome", ("-fsw_lazy_refresh", "0"))):
        ct_lib = os.path.join(work, f"lib_{route}")
        runs[route] = train_fsw(route, ct_feats, ct_tree, ct_lib, n_ct, *flags)
        check_subtree_models(ct_lib, ct_clades, "NeuralNetFSW")
    out["kmer_hist_launches"] = kmer_launches
    out["contigs"] = {"subtrees": n_ct, "longest_point_set": longest, "padded": padded}

    shutil.copy(os.path.join(paths["lib"], "classifier_model.ckpt"), lib_fsw)
    serve = serve_on_card("trained_fsw", work, lib_fsw, q_dir, q_names, FSW_MODEL_BYTES, K_MAIN,
                          n_classes=len(sizes))
    out["serve"] = {"stage_s": serve["stage_s"], "launches": serve["launches"]}
    out["rebuild_tolerance_used"] = compare_fsw_rebuilds(work, paths["rb_fna"],
                                                         paths["rb_tree_dir"])
    return out


# -- phase 4c': FSW at k=8 --------------------------------------------------------


def train_fsw_shared(k: int, epochs: int, feats: str, tree_dir: str, out_dir: str, dev: str,
                     route: str, clades: tuple[int, ...] | None = None) -> dict:
    """train_model_set at k on `dev` (every subtree, or `clades`) for `epochs`
    epochs on the shared route, lazy (default flags) or exact
    (-fsw_lazy_refresh 0); checks its route lines and, on the card, that
    every training sort took the cluster path (an export sorts each
    genome's own padded point set, on the path its length takes) and each
    route launched its kernels (on the CPU none); returns its launches,
    seconds, steps, refresh seconds and peak."""
    os.makedirs(out_dir, exist_ok=True)
    flags = ("-fsw_lazy_refresh", "0") if route == "exact_shared" else ()
    only = ("-clade", *map(str, clades)) if clades is not None else ()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TrainerClock() as clock:
        _, launches = counted(cli_main, [
            "train_model_set", "-input_dir", feats, "-subtrees",
            os.path.join(tree_dir, "tree.subtrees"), "-true_dist", tree_dir, "-o", out_dir,
            "-e", str(epochs), *flags, *only, "-device", dev])
    n = len(clades) if clades is not None else len(set(read_subtree_rows(tree_dir).values()))
    routes = fsw_routes(canonical_vocab_size(k))[route]
    lines = route_lines(out_dir)
    check(lines == list(routes) * n,
          f"k={k} {route} on {dev}: route lines {lines}, expected {routes} x {n}")
    steps = sum(s for s, _ in clock.epochs["distance"])
    out = {"seconds": time.perf_counter() - t0, "launches": launches, "steps": steps,
           "refreshes": len(clock.refresh_s), "refresh_s": [t for _, t in clock.refresh_s],
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20 if dev == "cuda" else None}
    check(("lazy" in route) == (out["refreshes"] > 0), f"k={k} {route}: {out['refreshes']} refreshes")
    if dev == "cpu":
        check(not any(launches.values()), f"k={k} {route} on the CPU launched a kernel: {launches}")
    else:
        training = launches["sort_rows"] - sum(e["sort_rows"] for e in clock.exports)
        check(launches["sort_rows_long"] >= training >= 1,
              f"k={k} {route}: training sorts off the cluster path ({launches}, exports "
              f"{clock.exports})")
        check((launches["refresh_planes"] >= 1) == (route == "lazy_shared"),
              f"k={k} {route}: refresh_planes launches ({launches})")
        check(exact_launches_fit(route, launches, clock.exports, steps),
              f"k={k} {route}: exact_coefficients launches ({launches}) over {steps} steps and "
              f"the exports {clock.exports}")
    log(f"phase fsw_k{k} {route} on {dev}: {json.dumps(out)}")
    return out


def query_on_both(work: str, tag: str, feats: str, lib: str, k: int, clade: int,
                  members: list[str], cpu_members: list[str]) -> dict:
    """``query`` of `members`' point sets, all sent to subtree `clade` of the
    FSW library `lib`, on the card, and of `cpu_members` on the CPU; checks
    the rows, that the card sorted (one exact coefficient launch a sort) and
    the CPU launched nothing, and holds the card's embeddings and the
    library's exported ones to the CPU's within the FSW tolerances; returns
    each device's launches and seconds and the tolerance used."""
    query = {}
    for dev, names in (("cuda", members), ("cpu", cpu_members)):
        q_dir, q_out = (os.path.join(work, f"{tag}_{d}_{dev}") for d in ("q", "q_out"))
        os.makedirs(q_dir)
        os.makedirs(q_out)
        for g in names:
            os.symlink(os.path.join(feats, f"{g}_k{k}.npy"), os.path.join(q_dir, f"{g}_k{k}.npy"))
        with open(os.path.join(q_dir, "classes.out"), "w") as f:
            f.write("genome\ttop_class\n" + "".join(f"{g}\t{clade}\n" for g in names))
        t1 = time.perf_counter()
        _, query[dev] = counted(cli_main, ["query", "-input_dir", q_dir, "-model", lib,
                                           "-classes", q_dir, "-o", q_out, "-device", dev])
        query[f"{dev}_s"] = time.perf_counter() - t1
    check(query["cuda"]["sort_rows"] >= 1
          and query["cuda"]["exact_coefficients"] == query["cuda"]["sort_rows"]
          and not any(query["cpu"].values()), f"{tag} query launches {query}")
    emb = {dev: read_table(os.path.join(work, f"{tag}_q_out_{dev}", f"embedding_subtree_{clade}.emb"),
                           header=False)[1] for dev in ("cuda", "cpu")}
    _, exported = read_table(os.path.join(lib, f"embeddings_subtree_{clade}.csv"), header=False)
    check(sorted(emb["cuda"]) == sorted(members) and sorted(emb["cpu"]) == sorted(cpu_members),
          f"{tag} query rows")
    tol = Tolerances()
    for what, ref in (("query cuda", emb["cuda"]), ("export cuda", exported)):
        tol.compare(f"{what} vs query cpu", np.array([ref[g] for g in cpu_members]),
                    np.array([emb["cpu"][g] for g in cpu_members]), FSW_RTOL, FSW_ATOL)
    tol.check_all(f"FSW {tag} embeddings, cuda vs the CPU's plain path")
    return {**query, "tolerance_used": tol.used}


def phase_fsw_k8(work: str, paths: dict, q_dir: str, q_names: list[str]) -> dict:
    """FSW at k=8 through the CLI on the card against the CPU (see the module
    docstring, phase 4)."""
    t0 = time.perf_counter()
    fna, tree_dir = paths["rb_fna"], paths["rb_tree_dir"]
    clades = read_subtree_rows(tree_dir)
    n_clades = len(set(clades.values()))
    launches, feats = {}, {}
    for dev in ("cuda", "cpu"):
        feats[dev] = os.path.join(work, f"k8_npy_{dev}")
        _, launches[f"get_kmers_{dev}"] = counted(cli_main, [
            "get_kmers", "-input_dir", fna, "-output_dir", feats[dev], "-k", str(K8), "-device", dev])
    same_files(feats["cuda"], feats["cpu"], (".npy",))
    check(launches["get_kmers_cuda"]["kmer_hist"] >= 1 and not any(launches["get_kmers_cpu"].values()),
          f"k=8 get_kmers launches {launches}")
    points = [np.load(os.path.join(feats["cuda"], f), mmap_mode="r").shape[0]
              for f in os.listdir(feats["cuda"])]

    lib = os.path.join(work, "lib_k8")  # the classifier and every subtree's default-flag model
    os.makedirs(lib)
    _, launches["get_frequencies"] = counted(cli_main, [
        "get_frequencies", "-input_dir", fna, "-output_dir", lib, "-k", str(K8)])
    _, launches["train_classifier"] = counted(cli_main, [
        "train_classifier", "-input_dir", lib, "-subtrees", os.path.join(tree_dir, "tree.subtrees"),
        "-o", lib, "-e", str(FSW_K8_EPOCHS)])
    tol = Tolerances()
    for route, on_card, on_cpu in (("lazy_shared", None, FSW_REBUILD_CLADES),
                                   ("exact_shared", (0,), (0,))):
        lib_gpu = lib if route == "lazy_shared" else os.path.join(work, f"lib_k8_{route}_cuda")
        lib_cpu = os.path.join(work, f"lib_k8_{route}_cpu")
        launches[route] = train_fsw_shared(K8, FSW_K8_EPOCHS, feats["cuda"], tree_dir, lib_gpu,
                                           "cuda", route, on_card)["launches"]
        train_fsw_shared(K8, FSW_K8_EPOCHS, feats["cuda"], tree_dir, lib_cpu, "cpu", route, on_cpu)
        tol.subtree_models(lib_gpu, lib_cpu, clade_batches(clades, on_cpu), FSW_K8_EPOCHS, FSW_RTOL)
    check_subtree_models(lib, clades, "NeuralNetFSW", k=K8)
    log(f"phase fsw_k8: {len(points)} genomes, point sets of {min(points)}-{max(points)} k-mers "
        f"(V = {V8}), .npy identical on cuda and cpu; lazy (subtrees {FSW_REBUILD_CLADES}) and "
        f"exact (subtree 0) training cuda vs cpu: tolerance used (max |a-b| / (atol + rtol |b|), "
        f"at most 1) and largest differences {json.dumps(tol.used)}")
    tol.check_all("FSW k=8 training cuda vs cpu")

    query = drive_path("fsw_k8", work, lib, q_dir, q_names, fsw_model_bytes(K8), K8,
                       n_classes=n_clades, k=K8)
    check(query["launches"]["sort_rows_long"] >= 1,
          f"k=8 query: the cluster path of sort_rows did not launch ({query['launches']})")
    launches["query"] = query["launches"]
    out = {"seconds": time.perf_counter() - t0, "launches": launches,
           "point_sets": [min(points), max(points)], "tolerance_used": tol.used,
           "query": {key: query[key] for key in ("stage_s", "cuda_vs_cpu", "peak_mib")}}
    log(f"phase fsw_k8: {json.dumps(out)}")
    return out


# -- phase 4c (k=9): FSW at k=9 ----------------------------------------------------


def k9_timings(dev) -> dict:
    """At fsw_k9's shapes on the card: the lazy refresh's planes kernel over
    K9_REFRESH_ITEMS items (unstaged: V is past the staging) beside its
    bound; the training chunk's sort (K9_TRAIN_CHUNK rows of V on the
    cluster path, one weight row) through ``phase_sort_timings``; and the
    exact shared coefficient kernels on the chunk's 16 items, forward and
    backward, beside their lane-work bounds (60 and 120 instructions a
    coefficient)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    n, c = K9_REFRESH_ITEMS, FSW_OUT_DIM
    digits = fsw_model.vocab_digits(K9, dev)
    w = torch.rand(n, V9, generator=gen, device=dev)
    w[w < 0.2] = 0.0  # absent k-mers
    wn = fsw_model._normalized(w)
    del w
    ps, _, perm = sort_rows(torch.randn(c, V9, generator=gen, device=dev), wn[:1])
    freqs = torch.arange(c, dtype=torch.float32, device=dev)
    refresh_ms = cuda_ms(lambda: refresh_planes(ps, perm, wn, freqs, digits), reps=3, warmup=1)
    out = {"refresh": {"shape": [n, c, V9], "ms": refresh_ms, "bound_ms": 1e3 * n * c * V9
                       * REFRESH_INSTR_PER_COEFF / H100_LANE_INSTR_PER_S, "bound_by": "operations"}}
    b, chunk = BATCH_SIZE, K9_TRAIN_CHUNK
    cp, cperm, cwn = ps[:chunk].contiguous(), perm[:chunk].contiguous(), wn[:b].contiguous()
    cxi = freqs[c - chunk:].contiguous()  # the last chunk's frequencies, the largest phases
    grad = torch.randn(b, chunk, generator=gen, device=dev)
    coefficients = b * chunk * V9
    out["exact_shared"] = {
        "shape": [b, chunk, V9],
        "forward_ms": cuda_ms(lambda: exact_coefficients_shared(cp, cperm, cwn, cxi), reps=20),
        "backward_ms": cuda_ms(lambda: exact_coefficients_shared_grad(cp, cperm, cwn, cxi, grad),
                               reps=20),
        "forward_bound_ms": 1e3 * 60 * coefficients / H100_LANE_INSTR_PER_S,
        "backward_bound_ms": 1e3 * 120 * coefficients / H100_LANE_INSTR_PER_S}
    del ps, perm, wn, digits
    torch.cuda.empty_cache()
    out["train_sort"] = phase_sort_timings(dev, (chunk, V9, 1), reps=20)
    log(f"phase fsw_k9: timings {json.dumps(out)}")
    return out


def phase_fsw_k9(work: str) -> dict:
    """FSW at k=9 through the CLI on the card against the CPU (see the module
    docstring, phase 4)."""
    t0 = time.perf_counter()
    fna, tree_dir = divided_backbone(work, "k9", SEED + 90, K9_LEAVES, K9_GENOME, K9_LEAVES)
    clades = read_subtree_rows(tree_dir)
    check(set(clades.values()) == {0}, f"k=9: subtrees {sorted(set(clades.values()))}, not one")
    feats, launches = {}, {}
    for dev in ("cuda", "cpu"):
        feats[dev] = os.path.join(work, f"k9_npy_{dev}")
        _, launches[f"get_kmers_{dev}"] = counted(cli_main, [
            "get_kmers", "-input_dir", fna, "-output_dir", feats[dev], "-k", str(K9),
            "-device", dev])
    same_files(feats["cuda"], feats["cpu"], (".npy",))
    points = [np.load(os.path.join(feats["cuda"], f"{g}_k{K9}.npy"), mmap_mode="r").shape[0]
              for g in clades]
    check(V9 <= 3 * bucket_items(max(points), floor=128) and TILE_ELEMS < V9 <= CLUSTER_ELEMS,
          f"k=9 point sets of {min(points)}-{max(points)} k-mers: not the shared route")
    out = {"point_sets": [min(points), max(points)], "routes": {}}
    tol = Tolerances()
    libs = {}
    for route in ("lazy_shared", "exact_shared"):
        for dev in ("cuda", "cpu"):
            libs[route, dev] = os.path.join(work, f"lib_k9_{route}_{dev}")
            out["routes"][f"{route}_{dev}"] = train_fsw_shared(
                K9, FSW_K9_EPOCHS, feats["cuda"], tree_dir, libs[route, dev], dev, route)
        check_subtree_models(libs[route, "cuda"], clades, "NeuralNetFSW", k=K9)
        tol.subtree_models(libs[route, "cuda"], libs[route, "cpu"], clade_batches(clades),
                           FSW_K9_EPOCHS, FSW_RTOL)
    log(f"phase fsw_k9: {len(points)} genomes, point sets of {min(points)}-{max(points)} k-mers "
        f"(V = {V9}), .npy identical on cuda and cpu; lazy and exact training cuda vs cpu: "
        f"tolerance used (max |a-b| / (atol + rtol |b|), at most 1) and largest differences "
        f"{json.dumps(tol.used)}")
    tol.check_all("FSW k=9 training cuda vs cpu")

    # the lazy library's query of K9_QUERIES of its genomes, on the card and on the CPU
    members = sorted(clades)[:K9_QUERIES]
    out["query"] = query_on_both(work, "k9", feats["cuda"], libs["lazy_shared", "cuda"], K9, 0,
                                 members, members)
    out["tolerance_used"] = tol.used
    out["timings"] = k9_timings(torch.device("cuda"))
    out["seconds"] = time.perf_counter() - t0
    log(f"phase fsw_k9: {json.dumps(out)}")
    return out


# -- phase 4c'': FSW at k=10 -------------------------------------------------------


def train_fsw_k10(feats: str, tree_dir: str, out_dir: str, route: str,
                  clade: int | None = None) -> dict:
    """train_model_set at k=10 on the card (every subtree, or `clade`) for
    FSW_K10_EPOCHS epochs on the per-genome route; checks its route lines and
    that sort_rows launched in training on the radix path (none on the
    cluster path); returns its launches, refreshes and seconds."""
    os.makedirs(out_dir)
    flags = ("-fsw_lazy_refresh", "0") if route == "exact_pergenome" else ()
    only = ("-clade", str(clade)) if clade is not None else ()
    t0 = time.perf_counter()
    with TrainerClock() as clock:
        _, launches = counted(cli_main, [
            "train_model_set", "-input_dir", feats, "-subtrees",
            os.path.join(tree_dir, "tree.subtrees"), "-true_dist", tree_dir, "-o", out_dir,
            "-e", str(FSW_K10_EPOCHS), *flags, *only])
    n = 1 if clade is not None else len(set(read_subtree_rows(tree_dir).values()))
    lines = route_lines(out_dir)
    check(lines == list(fsw_routes(V10)[route]) * n,
          f"k=10 {route}: route lines {lines}, expected {fsw_routes(V10)[route]} x {n}")
    exports = sum(e["sort_rows"] for e in clock.exports)
    out = {"seconds": time.perf_counter() - t0, "launches": launches,
           "launches_outside_exports": launches["sort_rows"] - exports,
           "refreshes": len(clock.refresh_s), "refresh_s": [t for _, t in clock.refresh_s]}
    check(out["launches_outside_exports"] >= 1 and launches["sort_rows_long"] == 0
          and launches["sort_rows_radix"] == launches["sort_rows"],
          f"k=10 {route}: sort_rows launches {launches}, {exports} in the exports")
    check((route == "lazy_pergenome") == (out["refreshes"] > 0),
          f"k=10 {route}: {out['refreshes']} refreshes")
    check(pergenome_launches_fit(route, launches, out["refreshes"]),
          f"k=10 {route}: pergenome_planes launches ({launches}) over {out['refreshes']} "
          "refreshes")
    steps = sum(n for n, _ in clock.epochs["distance"])
    check(exact_launches_fit(route, launches, clock.exports, steps),
          f"k=10 {route}: exact_coefficients launches ({launches}) over {steps} steps and "
          f"the exports {clock.exports}")
    return out


def kernel_events(trace_dir: str) -> list[str]:
    """Names of the CUDA kernel events of the one Chrome trace in trace_dir."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"{trace_dir}: trace files {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "kernel"]


def measured_peak(fn, *args) -> int:
    """The device memory fn(*args) allocates at its peak beyond what was
    allocated before it (torch.cuda.max_memory_allocated)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn(*args)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def c5_readings(lib: str, feats: str, names: list[str], clade: int) -> dict:
    """Device memory of one per-genome refresh group and of one sliced
    forward on the card at the backbone's point sets, against the budgets'
    counts (``refresh_transient_bytes`` for the group ``pick_refresh_group``
    chose; the chunk ``auto_slice_chunk`` chose times ``slice_sort_bytes``,
    beside the forward's weight rows) and against the counts copied from the
    JAX package, which leave out the sort's radix scratch (and, for the
    refresh, the port's jvp). Fails if a measured peak passes its count by
    more than C5_ALLOC_SLACK."""
    _, _, params = load_checkpoint(os.path.join(lib, f"model_subtree_{clade}.ckpt"))
    model = params_from_jax(params).to("cuda")
    x = torch.from_numpy(train_distance.pad_point_sets(
        [np.load(os.path.join(feats, f"{g}_k{K10}.npy")) for g in names])).to("cuda")
    n_genomes, n = x.shape[:2]
    check(CLUSTER_ELEMS < n, f"k=10 point sets padded to {n}: not on the radix path")
    out = {"point_set_length": n}
    with torch.no_grad():
        dims = (K10, FSW_BASE_DIM)
        group = fsw_lazy.pick_refresh_group(FSW_OUT_DIM, n, "cuda", points=dims)
        check(group >= 1, f"k=10: no refresh group fits at N = {n}")
        peak = measured_peak(fsw_model.fsw_lazy_refresh_pergenome, model.slices, model.freqs,
                             model.lookup, x[:group], group)
        count = fsw_lazy.refresh_transient_bytes(FSW_OUT_DIM, n, group, dims)
        old = 4 * (3 * group + 4) * FSW_OUT_DIM * n  # the JAX package's formula
        out["refresh_group"] = {"group": group, "measured": peak, "estimate": count,
                                "old_estimate": old, "measured_over_estimate": peak / count,
                                "measured_over_old": peak / old}
        chunk = fsw_model.auto_slice_chunk(n_genomes, n, FSW_OUT_DIM, "cuda")
        check(chunk >= 1, f"k=10: the forward of {n_genomes} x {n} takes all slices at once")
        points = fsw_model.lookup_points(model.lookup, x[..., :K10].long())
        weights = x[..., -1]
        peak = measured_peak(fsw_model.fsw_embed, model.slices, model.freqs, points, weights,
                             chunk)
        count = chunk * fsw_model.slice_sort_bytes(n_genomes, n) + 4 * n_genomes * n
        old = chunk * 16 * n_genomes * n + 4 * n_genomes * n
        out["sliced_forward"] = {"rows": n_genomes, "chunk": chunk, "measured": peak,
                                 "estimate": count, "old_estimate": old,
                                 "measured_over_estimate": peak / count,
                                 "measured_over_old": peak / old}
    del x, points, model
    torch.cuda.empty_cache()
    log(f"phase fsw_k10: device memory against the budgets' counts (bytes) {json.dumps(out)}")
    for key in ("refresh_group", "sliced_forward"):
        check(out[key]["measured"] <= out[key]["estimate"] + C5_ALLOC_SLACK,
              f"k=10 {key}: measured {out[key]['measured']} B over its count "
              f"{out[key]['estimate']} B")
    return out


def c6_reading() -> dict:
    """Device memory of one shared-route lazy refresh at k = 9 widths (V =
    131,072, FSW_OUT_DIM slices) of C6_ITEMS items of random weights, in
    groups of the G ``pick_refresh_group`` picks on this card, against
    ``shared_refresh_bytes`` and against the JAX package's (3G + 4) f32
    buffers of (C, V). Fails if the measured peak passes its count by more
    than C5_ALLOC_SLACK."""
    v = canonical_vocab_size(K9)
    group = fsw_lazy.pick_refresh_group(FSW_OUT_DIM, v, "cuda", items=C6_ITEMS)
    check(group >= 1, f"k=9: no shared refresh group fits {C6_ITEMS} items")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    digits = fsw_model.vocab_digits(K9, torch.device("cuda"))
    model = init_fsw_dist_embed_(FSWDistEmbed(K9, FSW_BASE_DIM, FSW_OUT_DIM, HIDDEN_SIZE_FC1,
                                              EMBEDDING_SIZE).to("cuda"), gen)
    with torch.no_grad():
        points = fsw_model.lookup_points(model.lookup, digits)
        w = torch.rand(C6_ITEMS, v, generator=gen, device="cuda")
        refresh_planes.launches = 0
        peak = measured_peak(fsw_model.fsw_lazy_refresh, model.slices, model.freqs, points, digits,
                             w, group)
    # the plain version's count, an upper bound where the kernel runs
    count = fsw_lazy.shared_refresh_bytes(FSW_OUT_DIM, v, group, C6_ITEMS)
    # the kernel route's stages: the sort (weights, keys, its outputs), then
    # the weights, the sort's outputs, the kernel's records and the planes
    cv = 4 * FSW_OUT_DIM * v
    kernel_count = max(
        4 * C6_ITEMS * v + cv + sort_transient_bytes(FSW_OUT_DIM, v, 1),
        4 * C6_ITEMS * v + 3 * cv + scratch_bytes(FSW_OUT_DIM, v)
        + 4 * C6_ITEMS * FSW_OUT_DIM * (4 * K9 + 1))
    old = 4 * (3 * group + 4) * FSW_OUT_DIM * v  # the JAX package's formula
    out = {"vocab": v, "items": C6_ITEMS, "group": group, "measured": peak, "estimate": count,
           "kernel_estimate": kernel_count, "old_estimate": old,
           "measured_over_estimate": peak / count,
           "measured_over_kernel_estimate": peak / kernel_count,
           "measured_over_old": peak / old, "launches": refresh_planes.launches}
    del model, points, w
    torch.cuda.empty_cache()
    log(f"phase fsw_k10: C6, a shared refresh at k=9 against its count (bytes) {json.dumps(out)}")
    check(out["launches"] == 1, f"k=9 shared refresh: refresh_planes launched {out['launches']} "
          "times")
    check(peak <= count, f"k=9 shared refresh: measured {peak} B over its count {count} B")
    check(peak <= kernel_count + C5_ALLOC_SLACK, f"k=9 shared refresh: measured {peak} B over "
          f"the kernel route's count {kernel_count} B")
    return out


def phase_fsw_k10(work: str) -> dict:
    """FSW at k=10 on the card (see the module docstring, phase 4)."""
    t0 = time.perf_counter()
    fna, tree_dir = divided_backbone(work, "k10", SEED + 110, K10_LEAVES, K10_GENOME, K10_SIZE)
    clades = read_subtree_rows(tree_dir)
    feats = os.path.join(work, "k10_npy")
    _, get_kmers_launches = counted(cli_main, [
        "get_kmers", "-input_dir", fna, "-output_dir", feats, "-k", str(K10)])
    check(get_kmers_launches["kmer_hist"] >= 1, f"k=10 get_kmers launches {get_kmers_launches}")
    points = {g: np.load(os.path.join(feats, f"{g}_k{K10}.npy"), mmap_mode="r").shape[0]
              for g in clades}
    check(all(CLUSTER_ELEMS < v < V10 for v in points.values()),
          f"k=10 point sets of {min(points.values())}-{max(points.values())} k-mers")
    out = {"get_kmers_launches": get_kmers_launches["kmer_hist"],
           "point_sets": [min(points.values()), max(points.values())],
           "subtrees": len(set(clades.values()))}

    lib = os.path.join(work, "lib_k10")
    out["lazy"] = train_fsw_k10(feats, tree_dir, lib, "lazy_pergenome")
    check_subtree_models(lib, clades, "NeuralNetFSW", k=K10)
    sizes = {c: sum(cl == c for cl in clades.values()) for c in set(clades.values())}
    clade = max(sorted(sizes), key=sizes.get)  # the largest subtree: up to K10_QUERIES queries
    check(sizes[clade] >= 2, f"k=10 subtrees of {sorted(sizes.values())} genomes")
    traces = os.path.join(work, "k10_traces")  # this phase's own: nothing else traces here
    os.environ[PROFILE_DIR_ENV] = traces
    try:
        exact_dir = os.path.join(work, "lib_k10_exact")
        out["exact"] = train_fsw_k10(feats, tree_dir, exact_dir, "exact_pergenome", clade)
    finally:
        del os.environ[PROFILE_DIR_ENV]
    check_subtree_models(exact_dir, {g: c for g, c in clades.items() if c == clade},
                         "NeuralNetFSW", k=K10)
    check(sorted(os.listdir(traces)) == [f"train_model_clade_{clade}"], f"traces {os.listdir(traces)}")
    kernels = kernel_events(os.path.join(traces, f"train_model_clade_{clade}"))
    radix_kernels = {name: sum(name in e for e in kernels) for name in RADIX_KERNELS}
    check(all(radix_kernels.values()), f"k=10 trace: radix kernels {radix_kernels} among "
          f"{len(kernels)} kernel events")
    out["trace"] = {"kernel_events": len(kernels), "radix_kernel_events": radix_kernels}

    # the query of K10_QUERIES backbone genomes, all sent to one subtree
    members = sorted(g for g, c in clades.items() if c == clade)[:K10_QUERIES]
    out["query"] = query_on_both(work, "k10", feats, lib, K10, clade, members, members[:2])
    cuda = out["query"]["cuda"]
    check(cuda["sort_rows_long"] == 0 and cuda["sort_rows_radix"] == cuda["sort_rows"],
          f"k=10 query launches {out['query']}")
    out["memory"] = c5_readings(lib, feats, sorted(clades), clade)
    out["memory"]["shared_refresh_k9"] = c6_reading()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase fsw_k10: {json.dumps(out)}")
    return out


# -- phase 4c''': the model zoo -----------------------------------------------------


def zoo_models(gen: torch.Generator):
    """(name, model, input) of each zoo model at kf2vec's default widths,
    drawn from `gen` one at a time; the input is "rows" (B, V) or "windows"
    (B, T, V)."""
    v, h, e, c = V_MAIN, HIDDEN_SIZE_FC1, EMBEDDING_SIZE, N_CLASSES
    for depth in (2, 3, 4):
        yield f"MLP_{depth}", zoo.MLP([v] + [h] * (depth - 1) + [e], gen), "rows"
    yield "ClassifierEmbed", zoo.ClassifierEmbed(v, h, e, c, gen), "rows"
    yield "ClassifierForked", zoo.ClassifierForked(v, h, e, c, gen), "rows"
    yield "MLPBN_train", zoo.MLPBN([v, h, e], generator=gen), "rows"
    yield "MLPBN_eval", zoo.MLPBN([v, h, e], generator=gen).eval(), "rows"
    yield "CNN", zoo.CNN(v, h, e, generator=gen), "rows"
    yield "CNN_double", zoo.CNN(v, h, e, double=True, generator=gen), "rows"
    yield "ClassifierTrans", zoo.ClassifierTrans(v, h, e, c, ZOO_HEADS, ZOO_FFN, gen), "rows"
    yield "BiRNN", zoo.BiRNN(v, e, ZOO_RNN_LAYERS, c, gen), "windows"


def phase_zoo(kf_dir: str) -> dict:
    """The zoo on the card against the same modules' CPU forward (see the
    module docstring, phase 4)."""
    t0 = time.perf_counter()
    rows = np.concatenate([kf_io.read_kf(os.path.join(kf_dir, f))[1]
                           for f in sorted(os.listdir(kf_dir)) if f.endswith(".kf")])
    x = torch.from_numpy(rows[:BATCH_SIZE].astype(np.float32) * np.float32(FEATURES_SCALER))
    check(tuple(x.shape) == (BATCH_SIZE, V_MAIN), f"zoo input {tuple(x.shape)}")
    windows = torch.stack([x.roll(-t, dims=0) for t in range(ZOO_WINDOWS)], dim=1)
    inputs = {"rows": x, "windows": windows}
    out = {}
    tol = Tolerances()
    for name, module, kind in zoo_models(torch.Generator().manual_seed(SEED + 120)):
        card = copy.deepcopy(module).to("cuda")
        with torch.no_grad():
            want = module(inputs[kind])
            got = card(inputs[kind].to("cuda"))
            torch.cuda.synchronize()
        want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
        rtol, atol = ZOO_LOOSE if name in ("ClassifierTrans", "BiRNN") else ZOO_TIGHT
        for i, (a, b) in enumerate(zip(got, want)):
            check(a.is_cuda and tuple(a.shape) == tuple(b.shape) and bool(torch.isfinite(a).all()),
                  f"zoo {name} output {i}: {tuple(a.shape)} on {a.device}")
            tol.compare(f"{name}[{i}]", a.cpu().numpy(), b.numpy(), rtol, atol)
        if name == "MLPBN_train":  # the running statistics one training forward moved
            state_gpu, state_cpu = zoo.zoo_state_to_jax(card), zoo.zoo_state_to_jax(module)
            tol.compare("MLPBN_train running state", state_gpu["bn1"]["var"],
                        state_cpu["bn1"]["var"], *ZOO_TIGHT)
        out[name] = {"params": sum(p.numel() for p in module.parameters())}
        del card
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase zoo: {len(out) - 1} models at V={V_MAIN}, hidden {HIDDEN_SIZE_FC1}, embedding "
        f"{EMBEDDING_SIZE}, batch {BATCH_SIZE}; cuda vs cpu tolerance used (max |a-b| / "
        f"(atol + rtol |b|), at most 1) and largest differences {json.dumps(tol.used)}; "
        f"{json.dumps(out)}")
    tol.check_all("zoo cuda vs cpu")
    return out


# -- phase 4d: chunk training -----------------------------------------------------


class GetChunksClock:
    """Times get_chunks' counting (``count_windows``) and its text formatting
    (``append_kf``) by wrapping the module's globals (restored on exit)."""

    def __init__(self):
        self.count_s = self.format_s = 0.0
        self._saved = []

    def __enter__(self):
        for name, key in (("count_windows", "count_s"), ("append_kf", "format_s")):
            fn = getattr(ingest_chunks, name)
            self._saved.append((name, fn))
            setattr(ingest_chunks, name, self._timed(fn, key))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved:
            setattr(ingest_chunks, name, fn)

    def _timed(self, fn, key):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            setattr(self, key, getattr(self, key) + time.perf_counter() - t0)
            return out
        return timed


class BatchRecorder:
    """Records every batch the chunk stores hand a trainer (a host copy),
    by wrapping both stores' ``batch`` (restored on exit)."""

    def __init__(self):
        self.batches: list[np.ndarray] = []
        self._saved = []

    def __enter__(self):
        for cls in (train_chunks.ChunkStore, train_chunks.DeviceChunkStore):
            fn = cls.batch
            self._saved.append((cls, fn))

            def recorded(*args, _fn=fn, **kw):
                out = _fn(*args, **kw)
                self.batches.append(out.cpu().numpy())
                return out
            cls.batch = recorded
        return self

    def __exit__(self, *exc):
        for cls, fn in self._saved:
            cls.batch = fn


def link_genomes(fna: str, out: str, names: list[str]) -> str:
    os.makedirs(out)
    for g in names:
        os.symlink(os.path.join(fna, f"{g}.fna"), os.path.join(out, f"{g}.fna"))
    return out


def store_lines(lib: str) -> list[str]:
    lines = []
    for name in sorted(os.listdir(lib)):
        if name.endswith(".log"):
            with open(os.path.join(lib, name)) as f:
                lines += [line.strip() for line in f if line.startswith("Chunk store:")]
    return lines


def train_chunks_cli(chunks_dir: str, full_dir: str, tree_dir: str, lib: str, epochs: int,
                     device: str, which=("classifier", "distance"), *flags: str) -> None:
    """The port's chunk trainers at full width (default widths, batch and
    learning rates)."""
    common = ["-input_dir", chunks_dir, "-input_dir_fullgenomes", full_dir, "-subtrees",
              os.path.join(tree_dir, "tree.subtrees"), "-o", lib, "-e", str(epochs),
              "-device", device, *flags]
    if "classifier" in which:
        cli_main(["train_classifier_chunks", *common])
    if "distance" in which:
        cli_main(["train_model_set_chunks", "-true_dist", tree_dir, *common])


def check_chunk_library(lib: str, clades: dict[str, int]) -> None:
    header, rows = read_table(os.path.join(lib, "backbone_classes.out"))
    n_classes = len(set(clades.values()))
    check(header[:4] == ["genome", "true_class", "top_class", "top_p"]
          and len(header) == 4 + n_classes and sorted(rows) == sorted(clades),
          "chunk backbone_classes.out")
    check(all(np.all(np.isfinite(r)) and int(r[0]) == clades[g] and abs(r[3:].sum() - 1) < 1e-4
              for g, r in rows.items()), "chunk backbone_classes.out values")
    name, meta, params = load_checkpoint(os.path.join(lib, "classifier_model.ckpt"))
    check(name == "NeuralNetClassifierOnly" and np.isfinite(meta["lowest_loss"])
          and np.shape(params["fc1"]["w"]) == (V_MAIN, HIDDEN_SIZE_FC1)
          and np.shape(params["fc3"]["w"]) == (HIDDEN_SIZE_FC1, n_classes),
          f"chunk classifier checkpoint {name} {meta}")
    check_subtree_models(lib, clades, "NeuralNet")


def compare_stores(work: str, chunks_dir: str, full_dir: str, tree_dir: str, clade: int) -> dict:
    """One subtree retrained for 2 epochs on the device store and on the
    host store: the batches bit for bit; losses, params and embeddings
    identical, or within the dense rebuild's tolerances where a step is not
    deterministic on the card."""
    runs = {}
    for store, budget in (("device", None), ("host", "1")):
        lib = os.path.join(work, f"lib_chunks_{store}")
        os.makedirs(lib)
        if budget:
            os.environ["KF2VEC_CHUNK_DEVICE_BUDGET"] = budget
        try:
            with BatchRecorder() as rec:
                train_chunks_cli(chunks_dir, full_dir, tree_dir, lib, 2, "cuda", ("distance",),
                                 "-clade", str(clade))
        finally:
            os.environ.pop("KF2VEC_CHUNK_DEVICE_BUDGET", None)
        want = "device-resident" if store == "device" else "host streaming"
        check(len(store_lines(lib)) == 1 and want in store_lines(lib)[0],
              f"{store} store: {store_lines(lib)}")
        runs[store] = (lib, rec.batches)
    (lib_d, b_d), (lib_h, b_h) = runs["device"], runs["host"]
    check(len(b_d) == len(b_h) > 0 and all(
        a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))
        for a, b in zip(b_d, b_h)), "device and host stores sampled other batches")
    _, m_d, p_d = load_checkpoint(os.path.join(lib_d, f"model_subtree_{clade}.ckpt"))
    _, m_h, p_h = load_checkpoint(os.path.join(lib_h, f"model_subtree_{clade}.ckpt"))
    identical = m_d == m_h and all(
        np.array_equal(p_d[layer][leaf], p_h[layer][leaf]) for layer in p_d for leaf in p_d[layer])
    tol = Tolerances()
    tol.subtree_models(lib_d, lib_h, {clade: len(b_d) // 2}, 2, REBUILD_RTOL)
    tol.check_all("device store vs host store")
    out = {"batches": len(b_d), "rows": int(sum(b.shape[0] for b in b_d)),
           "identical_params_and_losses": identical, "tolerance_used": tol.used}
    log(f"phase train_chunks: device store vs host store on subtree {clade}: {json.dumps(out)}")
    return out


def compare_chunk_rebuilds(work: str) -> dict:
    """A small chunk backbone: get_frequencies and get_chunks on the card, the
    chunk .kf of CHUNK_CPU_GENOMES genomes again on the CPU (bytes equal),
    then both chunk trainers at full width on the card and on the CPU from
    the card's files; checkpoints, classes and exports within the dense
    rebuild's tolerances."""
    rng = np.random.default_rng(SEED + 60)
    fna, nwk, _ = write_backbone(work, "cb", rng, CHUNK_RB_LEAVES, CHUNK_RB_GENOME)
    tree_dir = os.path.join(work, "tree_cb")
    os.makedirs(tree_dir)
    tree = os.path.join(tree_dir, "tree.nwk")
    with open(tree, "w") as f:
        f.write(nwk)
    cli_main(["divide_tree", "-tree", tree, "-size", str(CHUNK_RB_SIZE)])
    cli_main(["get_distances", "-tree", tree, "-subtrees", os.path.join(tree_dir, "tree.subtrees"),
              "-mode", "subtrees_only"])
    full, chunk_dirs = os.path.join(work, "cb_full"), {}
    os.makedirs(full)
    cli_main(["get_frequencies", "-input_dir", fna, "-output_dir", full, "-k", str(K_MAIN)])
    for dev in ("cuda", "cpu"):
        chunk_dirs[dev] = os.path.join(work, f"cb_chunks_{dev}")
        os.makedirs(chunk_dirs[dev])
    cli_main(["get_chunks", "-input_dir", fna, "-output_dir", chunk_dirs["cuda"], "-k", str(K_MAIN)])
    clades = read_subtree_rows(tree_dir)
    few = link_genomes(fna, os.path.join(work, "cb_fna_few"), sorted(clades)[:CHUNK_CPU_GENOMES])
    cli_main(["get_chunks", "-input_dir", few, "-output_dir", chunk_dirs["cpu"], "-k", str(K_MAIN),
              "-device", "cpu"])
    same = sorted(os.listdir(chunk_dirs["cpu"]))
    kf = [f for f in same if f.endswith(".kf")]
    check(len(kf) == CHUNK_CPU_GENOMES and all(
        read_bytes(os.path.join(chunk_dirs["cuda"], f)) == read_bytes(os.path.join(chunk_dirs["cpu"], f))
        for f in kf), "chunk .kf differs between cuda and cpu")
    libs = {}
    for dev in ("cuda", "cpu"):
        libs[dev] = os.path.join(work, f"lib_cb_{dev}")
        os.makedirs(libs[dev])
        train_chunks_cli(chunk_dirs["cuda"], full, tree_dir, libs[dev], CHUNK_RB_EPOCHS, dev)
    tol = Tolerances()
    _, m_gpu, p_gpu = load_checkpoint(os.path.join(libs["cuda"], "classifier_model.ckpt"))
    _, m_cpu, p_cpu = load_checkpoint(os.path.join(libs["cpu"], "classifier_model.ckpt"))
    tol.compare("lowest_loss", np.array([m_gpu["lowest_loss"]]), np.array([m_cpu["lowest_loss"]]),
                REBUILD_LOSS_RTOL, 0.0)
    tol.params(p_gpu, p_cpu, adam_drift(-(-len(clades) // BATCH_SIZE), CHUNK_RB_EPOCHS))
    tol.subtree_models(libs["cuda"], libs["cpu"], clade_batches(clades), CHUNK_RB_EPOCHS,
                       REBUILD_RTOL)
    _, cls_gpu = read_table(os.path.join(libs["cuda"], "backbone_classes.out"))
    _, cls_cpu = read_table(os.path.join(libs["cpu"], "backbone_classes.out"))
    for g in clades:
        tol.compare("classes", cls_gpu[g][2:], cls_cpu[g][2:], REBUILD_CLASS_RTOL,
                    REBUILD_CLASS_ATOL)
    log(f"phase train_chunks: chunk rebuild of {CHUNK_RB_LEAVES} genomes, -size {CHUNK_RB_SIZE}, "
        f"{CHUNK_RB_EPOCHS} epochs, cuda vs cpu: {len(kf)} chunk .kf identical; tolerance used "
        f"(max |a-b| / (atol + rtol |b|), at most 1) and largest differences {json.dumps(tol.used)}")
    tol.check_all("chunk rebuild cuda vs cpu")
    return tol.used


def phase_train_chunks(work: str, paths: dict, q_dir: str, q_names: list[str]) -> dict:
    """The chunked pipeline on the card (see the module docstring, phase 4)."""
    t_phase = time.perf_counter()
    clades = read_subtree_rows(paths["tree_dir"])
    subset = {g: c for c in sorted(set(clades.values()))
              for g in sorted(g for g, cl in clades.items() if cl == c)[:CHUNK_PER_CLADE]}
    fna = link_genomes(paths["fna"], os.path.join(work, "chunk_fna"), sorted(subset))
    chunks_dir, lib = os.path.join(work, "chunks_k7"), os.path.join(work, "lib_chunks")
    os.makedirs(chunks_dir)
    os.makedirs(lib)
    release_serving_caches()
    torch.cuda.reset_peak_memory_stats()
    kmer_hist.launches = sort_rows.launches = 0
    t0 = time.perf_counter()
    with GetChunksClock() as gc_clock:
        cli_main(["get_chunks", "-input_dir", fna, "-output_dir", chunks_dir, "-k", str(K_MAIN)])
    get_chunks_s = time.perf_counter() - t0
    get_chunks_launches = kmer_hist.launches
    rows = {}
    for f in os.listdir(chunks_dir):
        if f.endswith(".kf"):
            with open(os.path.join(chunks_dir, f)) as fh:
                rows[f[: -len(".kf")]] = sum(1 for _ in fh)
    check(sorted(rows) == sorted(subset) and min(rows.values()) >= 10,
          f"get_chunks wrote {len(rows)} files of {sorted(set(rows.values()))} rows")
    check(get_chunks_launches >= 1, "get_chunks: kmer_hist was not launched")
    kmer_hist.launches = sort_rows.launches = 0
    with TrainerClock() as clock:
        t1 = time.perf_counter()
        train_chunks_cli(chunks_dir, paths["lib"], paths["tree_dir"], lib, CHUNK_EPOCHS, "cuda",
                         ("classifier",))
        t2 = time.perf_counter()
        train_chunks_cli(chunks_dir, paths["lib"], paths["tree_dir"], lib, CHUNK_EPOCHS, "cuda",
                         ("distance",))
        t3 = time.perf_counter()
    launches = {"kmer_hist": kmer_hist.launches, "sort_rows": sort_rows.launches}
    peak = torch.cuda.max_memory_allocated()
    lines = store_lines(lib)
    check(len(lines) == 1 + len(set(subset.values())) and all("device-resident" in x for x in lines),
          f"chunk store lines {lines}")
    check_chunk_library(lib, subset)
    epoch_s = {kind: sum(t for _, t in runs) for kind, runs in clock.epochs.items()}
    out = {
        "genomes": len(rows), "windows": sum(rows.values()), "get_chunks_s": get_chunks_s,
        "get_chunks_count_s": gc_clock.count_s, "get_chunks_format_s": gc_clock.format_s,
        "get_chunks_launches": get_chunks_launches, "launches": launches,
        "classifier_s": t2 - t1, "distance_s": t3 - t2,
        "steps_per_s": {kind: clock.steps_per_s(kind, CHUNK_EPOCHS) for kind in clock.epochs},
        "outside_epochs_s": {"classifier": t2 - t1 - epoch_s["classifier"],
                             "distance": t3 - t2 - epoch_s["distance"]},
        "host_s": clock.host_s, "exports": clock.exports, "peak_mib": peak / 2**20,
    }
    log(f"phase train_chunks: cuda run ok, {json.dumps(out)}")
    serve = serve_on_card("trained_chunks", work, lib, q_dir, q_names, DENSE_MODEL_BYTES, None,
                          n_classes=len(set(subset.values())))
    out["serve"] = {"stage_s": serve["stage_s"], "launches": serve["launches"]}
    classes_out = os.path.join(serve["out_dir"], "classes.out")
    cli_main(["get_secondary_classes", classes_out])
    _, top = read_table(classes_out)
    for rank in ("second", "third"):
        _, ranked = read_table(os.path.join(serve["out_dir"], f"classes_{rank}Best.out"))
        check(sorted(ranked) == sorted(top) and all(
            int(ranked[g][0]) != int(top[g][0]) and ranked[g][1] <= top[g][1] for g in top),
            f"classes_{rank}Best.out")
    smallest = min(set(subset.values()), key=lambda c: sum(cl == c for cl in subset.values()))
    out["stores"] = compare_stores(work, chunks_dir, paths["lib"], paths["tree_dir"], smallest)
    out["rebuild_tolerance_used"] = compare_chunk_rebuilds(work)
    out["sampler"] = sampler_timings(chunks_dir, subset, torch.device("cuda"))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def sampler_timings(chunks_dir: str, subset: dict[str, int], dev) -> dict:
    """The distance trainer's batch (2 x 16 span rows) from the device store
    of the largest subtree of the phase and from its host store, with CUDA
    events; bound: the gathered prefix rows read and the batch written."""
    clade = max(set(subset.values()), key=lambda c: sum(cl == c for cl in subset.values()))
    paths = [os.path.join(chunks_dir, f"{g}.kf") for g, c in sorted(subset.items()) if c == clade]
    host = train_chunks.ChunkStore(paths)
    store = train_chunks.DeviceChunkStore(host.matrices, dev)
    _, spans = train_chunks.epoch_plan(SEED, 0, host.counts, 2)
    rows = spans[:, : 2 * BATCH_SIZE]
    spans_dev = torch.from_numpy(rows).to(dev)
    ms = cuda_ms(lambda: store.batch(spans_dev), reps=200)
    host_ms = cuda_ms(lambda: host.batch(rows, dev), reps=20)
    n_bytes = 2 * rows.shape[1] * V_MAIN * 4 + rows.shape[1] * V_MAIN * 4
    out = {"shape": f"{rows.shape[1]} span rows of V={V_MAIN} from {len(paths)} genomes",
           "ms": ms, "host_store_ms": host_ms, "bound_ms": n_bytes / H100_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "store_mib": store.prefix.numel() * 4 / 2**20}
    log(f"phase timings: chunk sampler {json.dumps(out)}")
    return out


# -- phase 4f: data-parallel training over ranks ------------------------------------


class RankedTrainer:
    """One trainer of the ranks phase: its CLI command line for an output
    directory, its kind (which TrainerClock series times it) and its
    checkpoints with the batches of one epoch and the exports' tolerance."""

    def __init__(self, name: str, kind: str, argv, checkpoints: dict[str, int], emb_rtol: float):
        self.name, self.kind, self._argv = name, kind, argv
        self.checkpoints, self.emb_rtol = checkpoints, emb_rtol

    def argv(self, out: str) -> list[str]:
        return [*self._argv, "-o", out, "-e", str(RANKS_EPOCHS), "-device", RANKS_DEVICE]

    @property
    def steps(self) -> int:
        return RANKS_EPOCHS * sum(self.checkpoints.values())


def ranked_trainers(work: str, paths: dict) -> tuple[list[RankedTrainer], int]:
    """The ranks phase's trainers on phase 4's data, and its smallest subtree:
    both classifiers on the 192 genomes of the chunk phase (3 classes), the
    distance trainers (dense, FSW lazy and exact) on the smallest subtree
    and the chunk distance trainer on its 64 genomes of the chunk phase."""
    tree_dir, lib = paths["tree_dir"], paths["lib"]
    subtrees = os.path.join(tree_dir, "tree.subtrees")
    clades = read_subtree_rows(tree_dir)
    chunks_dir = os.path.join(work, "chunks_k7")
    subset = sorted(f[: -len(".kf")] for f in os.listdir(chunks_dir) if f.endswith(".kf"))
    kf_dir = os.path.join(work, "ranks_kf")
    os.makedirs(kf_dir)
    for g in subset:
        os.symlink(os.path.join(lib, f"{g}.kf"), os.path.join(kf_dir, f"{g}.kf"))
    sizes = {c: sum(cl == c for cl in clades.values()) for c in set(clades.values())}
    c = min(sizes, key=sizes.get)
    n_subset_c = sum(clades[g] == c for g in subset)
    batches = {n: -(-n // BATCH_SIZE) for n in (len(subset), sizes[c], n_subset_c)}
    dist = ["-subtrees", subtrees, "-true_dist", tree_dir, "-clade", str(c)]
    fsw = ["train_model_set", "-input_dir", os.path.join(work, "bb_k7"), *dist]
    chunk = ["-input_dir", chunks_dir, "-input_dir_fullgenomes", lib]
    ckpt = f"model_subtree_{c}.ckpt"
    return [
        RankedTrainer("train_classifier", "classifier", ["train_classifier", "-input_dir", kf_dir,
                      "-subtrees", subtrees], {"classifier_model.ckpt": batches[len(subset)]}, 0),
        RankedTrainer("dense", "distance", ["train_model_set", "-input_dir", lib, "-no_fsw", *dist],
                      {ckpt: batches[sizes[c]]}, REBUILD_RTOL),
        RankedTrainer("fsw_lazy", "distance", fsw, {ckpt: batches[sizes[c]]}, FSW_RTOL),
        RankedTrainer("fsw_exact", "distance", [*fsw, "-fsw_lazy_refresh", "0"],
                      {ckpt: batches[sizes[c]]}, FSW_RTOL),
        RankedTrainer("train_classifier_chunks", "classifier",
                      ["train_classifier_chunks", *chunk, "-subtrees", subtrees],
                      {"classifier_model.ckpt": batches[len(subset)]}, 0),
        RankedTrainer("train_model_set_chunks", "distance", ["train_model_set_chunks", *chunk, *dist],
                      {ckpt: batches[n_subset_c]}, REBUILD_RTOL),
    ], c


def run_in_process(trainers: list[RankedTrainer], root: str) -> dict[str, dict]:
    """Each trainer in this process, its launch counts and the all-reduce
    counter set to 0 just before it: its steps/s over epochs 2 on, launches
    and bytes all-reduced per step."""
    out = {}
    for t in trainers:
        os.makedirs(os.path.join(root, t.name))
        kmer_hist.launches = sort_rows.launches = refresh_planes.launches = 0
        all_reduce_.bytes = all_reduce_.calls = 0
        with TrainerClock() as clock:
            cli_main(t.argv(os.path.join(root, t.name)))
        out[t.name] = {"steps_per_s": clock.steps_per_s(t.kind, RANKS_EPOCHS),
                       "launches": {"kmer_hist": kmer_hist.launches, "sort_rows": sort_rows.launches,
                                    "refresh_planes": refresh_planes.launches},
                       "all_reduce_bytes_per_step": all_reduce_.bytes / t.steps,
                       "all_reduce_calls": all_reduce_.calls}
    return out


def world_size_1(trainers: list[RankedTrainer], root: str) -> dict[str, dict]:
    """The trainers in this process inside a one-rank NCCL group (gloo on
    the CPU), joined through ``initialize_distributed`` from a launcher's
    variables and left after them."""
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}
    saved = {k: os.environ.get(k) for k in [*env, BACKEND_ENV]}
    os.environ.update(env)
    os.environ.pop(BACKEND_ENV, None)
    try:
        check(initialize_distributed(device=RANKS_DEVICE) and dist.get_world_size() == 1
              and dist.get_backend() == ("nccl" if RANKS_DEVICE == "cuda" else "gloo"),
              "world size 1: no NCCL group")
        return run_in_process(trainers, root)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def compare_world_size_1(trainers: list[RankedTrainer], plain: str, w1: str) -> dict:
    """Checkpoints of the one-rank group against the same runs without a
    group: params, best epoch and lowest loss bit for bit, or within
    RANKS_W1_RTOL where the masked loss takes other float operations (the
    classifier's local NLL sum over the batch count against the mean)."""
    out = {}
    for t in trainers:
        for ckpt in t.checkpoints:
            _, m_a, p_a = load_checkpoint(os.path.join(plain, t.name, ckpt))
            _, m_b, p_b = load_checkpoint(os.path.join(w1, t.name, ckpt))
            check(m_a["best_epoch"] == m_b["best_epoch"], f"{t.name}: best epochs differ")
            tol = Tolerances()
            tol.compare("lowest_loss", np.array([m_b["lowest_loss"]]), np.array([m_a["lowest_loss"]]),
                        RANKS_W1_RTOL, F32_TINY)
            flat_a, flat_b = flatten_params(p_a), flatten_params(p_b)
            identical = m_a == m_b and flat_a.keys() == flat_b.keys()
            for key in flat_a:
                tol.compare("params", flat_b[key], flat_a[key], RANKS_W1_RTOL, F32_TINY)
                identical &= bool(np.array_equal(flat_a[key], flat_b[key]))
            tol.check_all(f"{t.name} at world size 1 against no group")
            check(read_logs(os.path.join(w1, t.name)).count("bit-equal on 1 rank(s)")
                  == len(t.checkpoints), f"{t.name}: world size 1 replicas line")
            out[t.name] = {"bit_identical": identical, "tolerance_used": tol.used}
    return out


def read_logs(out_dir: str) -> str:
    text = ""
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".log"):
            with open(os.path.join(out_dir, name)) as f:
                text += f.read()
    return text


def query_codes(q_dir: str, work: str) -> str:
    """The 9 Mb query genome's encoded bases (records joined by k - 1
    invalid bases) in an .npy file; returns its path."""
    path = os.path.join(q_dir, f"q{N_QUERIES - 1:02d}.fastq")
    codes = concat_with_separators([encode_bases(seq) for _, seq in read_sequences_raw(path)], K_MAIN)
    check(codes.size >= BIG_GENOME, f"{path}: {codes.size} bases")
    out = os.path.join(work, "ranks_query.npy")
    np.save(out, codes)
    return out


def ranked_launch(trainers: list[RankedTrainer], root: str, codes: str, backend: str,
                  ranks: int) -> dict:
    """The trainers and count_canonical_sharded of the query genome over
    ``ranks`` ranks (``rank_steps``) of one ``mp_check`` launch, rank r writing to
    ``root/rank{r}``: only rank 0 writes; the ranks' params are bit-equal
    (the trainers' checksum all-reduce, one line per checkpoint in rank 0's
    logs); the sharded count equals the single-launch count exactly. Returns
    the ranks' reports and the count's seconds."""
    argvs = []
    for r in range(ranks):
        rank_root = os.path.join(root, f"rank{r}")
        steps = []
        for t in trainers:
            os.makedirs(os.path.join(rank_root, t.name))
            steps += ["--", *t.argv(os.path.join(rank_root, t.name))]
        steps += ["--", "count", codes, str(K_MAIN), RANKS_DEVICE, os.path.join(root, "hist.npy")]
        argvs.append([sys.executable, os.path.abspath(__file__), RANK_FLAG,
                      os.path.join(root, "report{rank}.json"), *steps])
    t0 = time.perf_counter()
    launch(argvs, backend, RANKS_TIMEOUT_S)
    wall = time.perf_counter() - t0
    reports = []
    for r in range(ranks):
        with open(os.path.join(root, f"report{r}.json")) as f:
            reports.append(json.load(f)["steps"])
    for t in trainers:
        for r in range(1, ranks):
            check(os.listdir(os.path.join(root, f"rank{r}", t.name)) == [],
                  f"{t.name}: rank {r} wrote files")
        check(read_logs(os.path.join(root, "rank0", t.name)).count(f"bit-equal on {ranks} rank(s)")
              == len(t.checkpoints), f"{t.name}: {ranks} ranks' replicas line")
    single = KmerCounter(K_MAIN, RANKS_DEVICE).dense_histogram(np.load(codes)).cpu().numpy()
    check(np.array_equal(np.load(os.path.join(root, "hist.npy")), single),
          f"count_canonical_sharded over {ranks} ranks differs from one launch")
    count_launches = [rep[-1]["launches"]["kmer_hist"] for rep in reports]
    check(min(count_launches) >= 1, f"count_canonical_sharded: kmer_hist launches {count_launches}")
    for t, steps in zip(trainers, zip(*reports)):
        check("fsw" not in t.name or min(s["launches"]["sort_rows"] for s in steps) >= 1,
              f"{t.name}: sort_rows did not launch on every rank")
    return {"reports": reports, "wall_s": wall, "count_launches": sum(count_launches)}


def compare_ranked(trainers: list[RankedTrainer], w1: str, rank0: str) -> dict:
    """Rank 0's checkpoints and exports against the one-rank group's within
    the cuda-vs-cpu rebuild's Adam sign-flip bound (two ranks sum the
    gradients in another order)."""
    tol = Tolerances()
    for t in trainers:
        a, b = os.path.join(rank0, t.name), os.path.join(w1, t.name)
        if t.kind == "classifier":
            _, m_a, p_a = load_checkpoint(os.path.join(a, "classifier_model.ckpt"))
            _, m_b, p_b = load_checkpoint(os.path.join(b, "classifier_model.ckpt"))
            tol.compare("lowest_loss", np.array([m_a["lowest_loss"]]),
                        np.array([m_b["lowest_loss"]]), REBUILD_LOSS_RTOL, 0.0)
            tol.params(p_a, p_b, adam_drift(t.checkpoints["classifier_model.ckpt"], RANKS_EPOCHS))
        else:
            tol.subtree_models(a, b, {int(ck[len("model_subtree_"):-len(".ckpt")]): n
                                      for ck, n in t.checkpoints.items()}, RANKS_EPOCHS, t.emb_rtol)
    tol.check_all("two ranks against one")
    return tol.used


def ranked_readings(trainers: list[RankedTrainer], reports: list[list[dict]]) -> dict:
    """Rank 0's steps/s over epochs 2 on and bytes all-reduced per step of
    each trainer."""
    out = {}
    for t, step in zip(trainers, reports[0]):
        later = [(n, s) for i, (n, s) in enumerate(step["epochs"][t.kind]) if i % RANKS_EPOCHS]
        out[t.name] = {"steps_per_s": sum(n for n, _ in later) / sum(s for _, s in later),
                       "all_reduce_bytes_per_step": step["all_reduce_bytes"] / t.steps,
                       "launches": step["launches"], "seconds": step["seconds"]}
    return out


RANK_FLAG = "--rank-steps"


class SortRowsRows:
    """Records the rows of every ``sort_rows`` call of the FSW model (by
    wrapping the name ``models/fsw.py`` calls, restored on exit); the
    wrapper's own launch count is untouched."""

    def __init__(self):
        self.rows: dict[int, int] = {}

    def __enter__(self):
        self._fn = fsw_model.sort_rows

        def recorded(keys, payload):
            self.rows[keys.shape[0]] = self.rows.get(keys.shape[0], 0) + 1
            return self._fn(keys, payload)

        fsw_model.sort_rows = recorded
        return self

    def __exit__(self, *exc):
        fsw_model.sort_rows = self._fn


def rank_steps(report_path: str, steps: list[list[str]]) -> None:
    """One rank of ``ranked_launch`` or ``grid_launch`` (``chip_smoke.py
    --rank-steps REPORT -- STEP -- STEP ...``, the launcher's variables
    set): the steps in turn in one process group, each a CLI command line,
    ``count CODES.npy K DEVICE OUT.npy`` (count_canonical_sharded of the
    encoded bases, rank 0 writing OUT) or ``grid N_DATA N_MODEL CMD ARGS``
    (a trainer on a grid with a model axis, ``parallel/mp_check.py``'s
    ``run_grid``). The launch counts and the all-reduce counters are set to
    0 just before each step and read just after it; TrainerClock times its
    epochs and SortRowsRows counts the rows of each sort. REPORT (``{rank}``
    in the path is the rank) gets every step's seconds, epochs, all-reduces
    (by group), launches and sort rows on this rank."""
    report = []
    for argv in steps:
        kmer_hist.launches = sort_rows.launches = refresh_planes.launches = 0
        all_reduce_.bytes = all_reduce_.calls = 0
        all_reduce_.bytes_by.clear()
        t0 = time.perf_counter()
        with TrainerClock() as clock, SortRowsRows() as sorts:
            if argv[0] == "count":
                codes, k, device, out_path = argv[1:]
                initialize_distributed(device=device)
                hist = count_canonical_sharded(np.load(codes), int(k), data_mesh(torch.device(device)))
                if is_coordinator():
                    np.save(out_path, hist)
            elif argv[0] == "grid":
                run_grid(argv[1], argv[2], argv[3:])
            else:
                cli_main(argv)
        report.append({"argv": argv, "seconds": time.perf_counter() - t0, "epochs": clock.epochs,
                       "all_reduce_calls": all_reduce_.calls, "all_reduce_bytes": all_reduce_.bytes,
                       "all_reduce_bytes_by": dict(all_reduce_.bytes_by),
                       "launches": {"kmer_hist": kmer_hist.launches,
                                    "sort_rows": sort_rows.launches,
                                    "refresh_planes": refresh_planes.launches},
                       "sort_rows_rows": {str(r): n for r, n in sorted(sorts.rows.items())}})
    rank = dist.get_rank()
    with open(report_path.format(rank=rank), "w") as f:
        json.dump({"rank": rank, "steps": report}, f)
    shutdown_distributed()


def rank_main(argv: list[str]) -> int:
    steps: list[list[str]] = []
    for arg in argv[1:]:
        if arg == "--":
            steps.append([])
        else:
            steps[-1].append(arg)
    rank_steps(argv[0], [step for step in steps if step])
    return 0


def phase_ranks(work: str, paths: dict, q_dir: str) -> tuple[dict, list[RankedTrainer]]:
    """Data-parallel training over ranks (see the module docstring, phase 4);
    returns the phase's readings and its trainers."""
    t_phase = time.perf_counter()
    trainers, clade = ranked_trainers(work, paths)
    root = os.path.join(work, "ranks")
    plain, w1 = os.path.join(root, "plain"), os.path.join(root, "w1")
    release_serving_caches()
    out = {"subtree": clade, "no_group": run_in_process(trainers, plain),
           "world_size_1": world_size_1(trainers, w1)}
    out["world_size_1_vs_no_group"] = compare_world_size_1(trainers, plain, w1)
    check(sum(out["world_size_1"][t]["launches"]["sort_rows"] for t in ("fsw_lazy", "fsw_exact")) >= 2,
          "world size 1: sort_rows did not launch in FSW training")
    log(f"phase ranks (a) world size 1 on NCCL: {json.dumps(out['world_size_1_vs_no_group'])}")
    codes = query_codes(q_dir, work)
    two = ranked_launch(trainers, os.path.join(root, "gloo2"), codes, "gloo", 2)
    out["two_ranks_gloo"] = ranked_readings(trainers, two["reports"])
    out["two_ranks_vs_world_size_1"] = compare_ranked(trainers, w1, os.path.join(root, "gloo2", "rank0"))
    out["count_sharded"] = {"launches": two["count_launches"],
                            "seconds": two["reports"][0][-1]["seconds"]}
    out["two_ranks_wall_s"] = two["wall_s"]
    log(f"phase ranks (b) two ranks sharing the card over gloo: launch {two['wall_s']:.1f} s, "
        f"against world size 1 (max |a-b| / (atol + rtol |b|), at most 1) "
        f"{json.dumps(out['two_ranks_vs_world_size_1'])}; count_canonical_sharded of the "
        f"{BIG_GENOME}-base query at R = 2 equals one launch")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        nccl = ranked_launch(trainers, os.path.join(root, "nccl2"), codes, "nccl", 2)
        out["two_cards_nccl"] = ranked_readings(trainers, nccl["reports"])
        out["two_cards_vs_world_size_1"] = compare_ranked(trainers, w1,
                                                          os.path.join(root, "nccl2", "rank0"))
        log(f"phase ranks (c) two cards on NCCL: ran, {json.dumps(out['two_cards_vs_world_size_1'])}")
    else:
        log(f"phase ranks (c) two cards on NCCL: not run, this machine has {n_cards} CUDA card "
            "(NCCL takes one card per rank); a true two-card run stays unverified")
    out["phase_s"] = time.perf_counter() - t_phase
    return out, trainers


def grid_launch(trainers: list[RankedTrainer], root: str, grid: tuple[int, int]) -> list[list[dict]]:
    """The trainers on ``grid`` (``rank_steps``' ``grid`` steps), every rank of
    one ``mp_check`` launch sharing the card over gloo, rank r writing to
    ``root/rank{r}``; returns the ranks' reports."""
    ranks = grid[0] * grid[1]
    argvs = []
    for r in range(ranks):
        steps = []
        for t in trainers:
            out = os.path.join(root, f"rank{r}", t.name)
            os.makedirs(out)
            steps += ["--", "grid", str(grid[0]), str(grid[1]), *t.argv(out)]
        argvs.append([sys.executable, os.path.abspath(__file__), RANK_FLAG,
                      os.path.join(root, "report{rank}.json"), *steps])
    launch(argvs, "gloo", RANKS_TIMEOUT_S)
    reports = []
    for r in range(ranks):
        with open(os.path.join(root, f"report{r}.json")) as f:
            reports.append(json.load(f)["steps"])
    return reports


def phase_model_axis(work: str, ranked: list[RankedTrainer]) -> dict:
    """The model axis (see the module docstring, phase 4): the ranks phase's
    classifier, dense and FSW trainers on the grid MODEL_AXIS_GRID, two ranks
    sharing the card over gloo, each holding half of every model."""
    t_phase = time.perf_counter()
    trainers = [t for t in ranked if t.name in MODEL_AXIS_TRAINERS]
    root = os.path.join(work, "model_axis")
    release_serving_caches()
    reports = grid_launch(trainers, root, MODEL_AXIS_GRID)
    rank0 = os.path.join(root, "rank0")
    ranks = len(reports)
    for t in trainers:
        for r in range(1, ranks):
            check(os.listdir(os.path.join(root, f"rank{r}", t.name)) == [],
                  f"model axis {t.name}: rank {r} wrote files")
        logs = read_logs(os.path.join(rank0, t.name))
        check(logs.count(f"bit-equal on {ranks} rank(s)") == len(t.checkpoints),
              f"model axis {t.name}: the gathered params are not bit-equal on {ranks} ranks")
        check(f"grid {MODEL_AXIS_GRID[0]} x {MODEL_AXIS_GRID[1]} (data x model)" in logs,
              f"model axis {t.name}: the Ranks line names no grid")
    out = {"grid": list(MODEL_AXIS_GRID), "trainers": {}}
    for t, steps in zip(trainers, zip(*reports)):
        fsw = t.name.startswith("fsw")
        for r, step in enumerate(steps):
            rows = step["sort_rows_rows"]
            # training sorts the rank's 256 slices; rank 0 also exports with
            # the gathered model, blocks of point sets x all 512 slices
            others = [n for n in rows if int(n) != FSW_OUT_DIM // 2
                      and not (r == 0 and int(n) % FSW_OUT_DIM == 0)]
            check(not fsw or (step["launches"]["sort_rows"] >= 1
                              and str(FSW_OUT_DIM // 2) in rows and not others),
                  f"model axis {t.name}: rank {r} sort_rows launches "
                  f"{step['launches']['sort_rows']}, rows per call {rows}")
        later = [(n, s) for i, (n, s) in enumerate(steps[0]["epochs"][t.kind]) if i % RANKS_EPOCHS]
        out["trainers"][t.name] = {
            "steps_per_s": sum(n for n, _ in later) / sum(s for _, s in later),
            "all_reduce_bytes_per_step": {  # a one-rank data group sums nothing
                group: steps[0]["all_reduce_bytes_by"].get(group, 0) / t.steps
                for group in ("data", "model", "world")},
            "sort_rows_launches": [step["launches"]["sort_rows"] for step in steps],
            "kmer_hist_launches": [step["launches"]["kmer_hist"] for step in steps],
            "refresh_planes_launches": [step["launches"]["refresh_planes"] for step in steps],
            "sort_rows_rows": [step["sort_rows_rows"] for step in steps],
            "seconds": steps[0]["seconds"]}
    out["vs_no_group"] = compare_ranked(trainers, os.path.join(work, "ranks", "plain"), rank0)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase model_axis: grid {MODEL_AXIS_GRID[0]} x {MODEL_AXIS_GRID[1]} over gloo on one "
        f"card, {json.dumps(out)}")
    return out


def phase_long_genome(dev) -> dict:
    """One genome of LONG_BLOCK x LONG_REPEATS > 2^31 bases counted on the
    card through KmerCounter (in pieces of 2^31 - 1 bases), exact against
    R x the block's counts + (R - 1) x the counts of the 2(k-1)-base junction
    between two copies."""
    k = K_MAIN
    rng = np.random.default_rng(SEED + 70)
    block = random_codes(rng, LONG_BLOCK)
    genome = np.tile(block, LONG_REPEATS)
    check(genome.size > counter_mod.PIECE_BASES, f"{genome.size} bases: one piece")
    junction = np.concatenate([block[-(k - 1):], block[: k - 1]])
    want = (LONG_REPEATS * count_canonical_numpy(block, k)
            + (LONG_REPEATS - 1) * count_canonical_numpy(junction, k))[canonical_vocab_codes(k)]
    before = kmer_hist.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = KmerCounter(k, device=dev).count_batch([[genome]])
    seconds = time.perf_counter() - t0
    check(np.array_equal(got[0], want), "long genome: counts != R x block + (R - 1) x junction")
    out = {"bases": int(genome.size), "windows_counted": int(got.sum()),
           "launches": kmer_hist.launches - before, "seconds": seconds}
    check(out["launches"] >= 1, "long genome: kmer_hist was not launched")
    log(f"phase long_genome: exact, {json.dumps(out)}")
    return out


# -- phase 5 -------------------------------------------------------------------


def library_hist(bases: torch.Tensor, offsets: torch.Tensor, k: int) -> torch.Tensor:
    """Yardstick: torch window codes + one torch.bincount (invalid windows
    to a trash bin). Timed here only; the port never calls it."""
    g, n_bins, n = offsets.numel() - 1, 4**k, bases.numel() - k + 1
    b = bases.long()
    fwd = torch.zeros(n, dtype=torch.int64, device=bases.device)
    rc = torch.zeros_like(fwd)
    valid = torch.ones(n, dtype=torch.bool, device=bases.device)
    for i in range(k):
        d = b[i : i + n]
        fwd += d << (2 * (k - 1 - i))
        rc += (3 - d) << (2 * i)
        valid &= d < INVALID
    pos = torch.arange(n, device=bases.device)
    genome = torch.searchsorted(offsets, pos, right=True) - 1
    valid &= pos + k <= offsets[genome + 1]
    idx = torch.where(valid, genome * n_bins + torch.minimum(fwd, rc), g * n_bins)
    return torch.bincount(idx, minlength=g * n_bins + 1)[:-1].view(g, n_bins)


def phase_timings(dev) -> dict:
    rng = np.random.default_rng(SEED + 2)
    g, length, k = PHASE5_G, PHASE5_LEN, K_MAIN
    bases, offsets = to_batch([random_codes(rng, length) for _ in range(g)], dev)
    kernel_ms = cuda_ms(lambda: kmer_hist(bases, offsets, k), reps=20)
    plain_ms = cuda_ms(lambda: kmer_hist_reference(bases, offsets, k), reps=3, warmup=1)
    library_ms = cuda_ms(lambda: library_hist(bases, offsets, k), reps=3, warmup=1)
    got, ref = kmer_hist(bases, offsets, k), kmer_hist_reference(bases, offsets, k)
    check(torch.equal(got, ref), "main-path shape: kernel != plain version")
    check(torch.equal(got.long(), library_hist(bases, offsets, k)), "yardstick disagrees")
    n_bytes = bases.numel() + offsets.numel() * 8 + g * 4**k * 4
    windows = g * (length - k + 1)
    bytes_ms = n_bytes / H100_BYTES_PER_S * 1e3
    # per window: rolling fwd (shift, or, and) and revcomp (shift, sub,
    # shift, or), the min, the validity test and the bin add
    ops_ms = windows * 10 / H100_INT_OPS_PER_S * 1e3
    out = {
        "shape": f"G={g} x {length} bases, k={k}",
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": n_bytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
    }
    # the same batch shape on low-complexity repeats: all windows of a warp
    # in one bin (homopolymer) or two (dinucleotide)
    repeats = {"homopolymer": np.zeros(length, np.uint8),
               "dinucleotide": np.tile(np.array([0, 1], np.uint8), length // 2)}
    for name, genome in repeats.items():
        rb, ro = to_batch([genome] * g, dev)
        out[f"ms_{name}"] = cuda_ms(lambda: kmer_hist(rb, ro, k), reps=10)
        check(torch.equal(kmer_hist(rb, ro, k), kmer_hist_reference(rb, ro, k)),
              f"{name} batch: kernel != plain version")
    log(f"phase timings: kmer_hist {json.dumps(out)}")
    return out


def phase_chunk_hist_timings(dev) -> dict:
    """``kmer_hist`` at the get_chunks shape: PHASE5_CHUNK_WINDOWS windows of
    a genome's 10 kb tiling as the genomes of one launch, k=7. The (G, 4^k)
    int32 output dominates the bytes."""
    rng = np.random.default_rng(SEED + 5)
    k, n = K_MAIN, PHASE5_CHUNK_WINDOWS
    seq = random_codes(rng, n * 10_000 - 5_000)
    spans = ingest_chunks.window_spans(seq.size, 10_000)
    check(len(spans) == n, f"{len(spans)} windows")
    bases, offsets = to_batch([seq[a:b] for a, b in spans], dev)
    kernel_ms = cuda_ms(lambda: kmer_hist(bases, offsets, k), reps=50)
    plain_ms = cuda_ms(lambda: kmer_hist_reference(bases, offsets, k), reps=5, warmup=1)
    library_ms = cuda_ms(lambda: library_hist(bases, offsets, k), reps=5, warmup=1)
    got = kmer_hist(bases, offsets, k)
    check(torch.equal(got, kmer_hist_reference(bases, offsets, k)), "get_chunks shape: kernel != plain")
    check(torch.equal(got.long(), library_hist(bases, offsets, k)), "get_chunks shape: yardstick")
    n_bytes = bases.numel() + offsets.numel() * 8 + n * 4**k * 4
    bytes_ms = n_bytes / H100_BYTES_PER_S * 1e3
    ops_ms = n * (10_000 - k + 1) * 10 / H100_INT_OPS_PER_S * 1e3
    out = {"shape": f"G={n} windows x 10,000 bases, k={k}", "ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": n_bytes,
           "bytes_ms": bytes_ms, "ops_ms": ops_ms}
    log(f"phase timings: kmer_hist at the get_chunks shape {json.dumps(out)}")
    return out


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def phase_host_text(work: str) -> dict:
    """Host text I/O, plain Python against the C++ library, on one run's
    data: TEXT_KF_ROWS `.kf` rows of V_MAIN frequencies (append_kf, read_kf)
    and TEXT_F32_ROWS rows of EMBEDDING_SIZE float32 (f32_row,
    read_embeddings_csv); the bytes and the values must be equal."""
    rng = np.random.default_rng(SEED + 90)
    counts = rng.integers(0, 200, (TEXT_KF_ROWS, V_MAIN)).astype(np.float64)
    freqs = counts / counts.sum(axis=1, keepdims=True)
    emb = rng.normal(size=(TEXT_F32_ROWS, EMBEDDING_SIZE)).astype(np.float32)

    def kf_text(append):
        f = io.StringIO()
        for i, row in enumerate(freqs):
            append(f, f"g{i}", row)
        return f.getvalue()

    def f32_text(row_fn):
        return "".join(f"a{i}\t" + row_fn(row) for i, row in enumerate(emb))

    out = {"kf": f"{TEXT_KF_ROWS} rows of {V_MAIN} frequencies",
           "f32": f"{TEXT_F32_ROWS} rows of {EMBEDDING_SIZE} float32"}
    plain_kf, out["kf_format_plain_s"] = timed(kf_text, kf_io.append_kf_plain)
    fast_kf, out["kf_format_cpp_s"] = timed(kf_text, kf_io.append_kf)
    check(fast_kf == plain_kf, "host text: .kf bytes differ between plain and C++")
    kf_path = os.path.join(work, "host_text.kf")
    with open(kf_path, "w") as f:
        f.write(fast_kf)
    (n_plain, m_plain), out["kf_parse_plain_s"] = timed(kf_io.read_kf_plain, kf_path)
    (n_fast, m_fast), out["kf_parse_cpp_s"] = timed(kf_io.read_kf, kf_path)
    check(n_fast == n_plain and np.array_equal(m_fast, m_plain) and np.array_equal(m_fast, freqs),
          "host text: .kf values differ between plain and C++")
    plain_f32, out["f32_format_plain_s"] = timed(f32_text, train_distance.f32_row_plain)
    fast_f32, out["f32_format_cpp_s"] = timed(f32_text, train_distance.f32_row)
    check(fast_f32 == plain_f32, "host text: f32_row bytes differ between plain and C++")
    emb_path = os.path.join(work, "host_text_embeddings.csv")
    with open(emb_path, "w") as f:
        f.write(fast_f32)
    (e_plain_names, e_plain), out["f32_parse_plain_s"] = timed(read_embeddings_csv_plain, emb_path)
    (e_fast_names, e_fast), out["f32_parse_cpp_s"] = timed(read_embeddings_csv, emb_path)
    check(e_fast_names == e_plain_names and np.array_equal(e_fast, e_plain) and np.array_equal(e_fast, emb),
          "host text: float32 rows differ between plain and C++")
    log(f"phase timings: host text {json.dumps(out)}")
    return out


def phase_sort_timings(dev, shape: tuple[int, int, int], reps: int) -> dict:
    """sort_rows at one shape against its plain version, one torch.sort and
    its bound, and a row on the cluster path with the cluster's launch
    shape."""
    r, n, p = shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    keys = torch.randn(r, n, generator=gen, device=dev)
    payload = torch.rand(p, n, generator=gen, device=dev)
    kernel_ms = cuda_ms(lambda: sort_rows(keys, payload), reps=2 * reps)
    plain_ms = cuda_ms(lambda: sort_rows_reference(keys, payload), reps=reps)
    # the one PyTorch call for the sorted keys and perm (the payload gather
    # is extra); timed here only, the port never calls it
    library_ms = cuda_ms(lambda: torch.sort(keys, dim=-1), reps=reps)
    got, ref = sort_rows(keys, payload), sort_rows_reference(keys, payload)
    check_sort(keys, payload, got, ref)
    # read 4 B of key per element and the payload rows once; write 4 B each
    # of sorted key, sorted payload and perm (the radix path's scratch is
    # traffic the function does not need, so none is counted)
    n_bytes = 4 * r * n + 4 * p * n + 12 * r * n
    bytes_ms = n_bytes / H100_BYTES_PER_S * 1e3
    ops_ms = r * n * math.log2(n) / H100_INT_OPS_PER_S * 1e3  # n log2 n comparisons a row
    out = {
        "shape": f"R={r} x N={n}, P={p}",
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": n_bytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "faster_than_torch_sort": kernel_ms < library_ms,
    }
    if tile_elems() < n <= cluster_elems():
        out["cluster"] = cluster_shape(n)
    log(f"phase timings: sort_rows {json.dumps(out)}")
    return out


def phase_refresh_timings(dev) -> dict:
    """The shared lazy refresh's planes at PHASE5_REFRESH: the kernel against
    its plain version on the card (each item's planes within twice the
    planes' float32 tolerance, 1e-5 + 1e-7 C relative, of the plain
    version's), its time beside its bound and the plain version's."""
    n, c = PHASE5_REFRESH
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    digits = fsw_model.vocab_digits(K_MAIN, dev)
    w = torch.rand(n, V_MAIN, generator=gen, device=dev)
    w[w < 0.2] = 0.0  # absent k-mers
    wn = fsw_model._normalized(w)
    ps, _, perm = sort_rows(torch.randn(c, V_MAIN, generator=gen, device=dev), wn[:1])
    args = (ps, perm, wn, torch.arange(c, dtype=torch.float32, device=dev), digits)
    got = refresh_planes(*args)
    want = refresh_planes_reference(*args, 8)
    err = max((torch.linalg.vector_norm(a[i] - b[i]) / torch.linalg.vector_norm(b[i])).item()
              for a, b in zip(got, want) for i in range(n))
    check(err <= 2 * (1e-5 + 1e-7 * c), f"refresh_planes at {(n, c, V_MAIN)}: relative error "
          f"{err} against the plain version")
    del got, want
    ms = cuda_ms(lambda: refresh_planes(*args), reps=20)
    plain_ms = cuda_ms(lambda: refresh_planes_reference(*args, 8), reps=2, warmup=1)
    bound_ms = 1e3 * n * c * V_MAIN * REFRESH_INSTR_PER_COEFF / H100_LANE_INSTR_PER_S
    out = {"shape": [n, c, V_MAIN], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "operations", "max_rel_err_vs_plain": err, "goal_ms": REFRESH_GOAL_MS,
           "goal_met": ms <= REFRESH_GOAL_MS}
    log(f"phase timings: refresh_planes {json.dumps(out)}")
    return out


def phase_pergenome_timings(dev) -> dict:
    """The per-genome refresh's planes at PHASE5_PERGENOME: the kernel against
    its plain version on the card (S and g2 within twice the planes' float32
    tolerance, 1e-5 + 1e-7 C relative, of the plain version's: the plain
    version's own float32 scan is most of the gap), its time beside its
    bound and the plain version's. The bound counts ps, ws and perm read once and the digits
    (12 B a position, 8k B a point), against 120 lane instructions a
    coefficient on the real points (padding adds no work)."""
    c, n, real = PHASE5_PERGENOME
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    digits = torch.randint(0, 4, (1, n, K10), generator=gen, device=dev)
    w = torch.rand(1, n, generator=gen, device=dev)
    keys = torch.randn(c, n, generator=gen, device=dev)
    digits[:, real:], w[:, real:] = 0, 0.0
    keys[:, real:] = keys[:, :1]  # the padding rows are one point
    ps, ws, perm = sort_rows(keys, fsw_model._normalized(w))
    del keys
    args = (ps, ws, perm, digits, torch.arange(c, dtype=torch.float32, device=dev))
    got = pergenome_planes(*args)
    want = pergenome_planes_reference(*args)
    err = max((torch.linalg.vector_norm(a[0] - b[0]) / torch.linalg.vector_norm(b[0])).item()
              for a, b in zip(got, want))
    check(err <= 2 * (1e-5 + 1e-7 * c), f"pergenome_planes at {(c, n, K10)}: relative "
          f"error {err} against the plain version")
    del got, want
    ms = cuda_ms(lambda: pergenome_planes(*args), reps=20)
    plain_ms = cuda_ms(lambda: pergenome_planes_reference(*args), reps=2, warmup=1)
    bytes_ms = 1e3 * (12 * c * n + 8 * K10 * n) / H100_BYTES_PER_S
    ops_ms = 1e3 * c * real * REFRESH_INSTR_PER_COEFF / H100_LANE_INSTR_PER_S
    out = {"shape": [1, c, n, K10], "real_points": real, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes_ms": bytes_ms, "operations_ms": ops_ms, "max_rel_err_vs_plain": err}
    log(f"phase timings: pergenome_planes {json.dumps(out)}")
    return out


def _exact_rel_errs(got, want) -> list[float]:
    return [(torch.linalg.vector_norm(a.double() - w) / torch.linalg.vector_norm(w)).item()
            for a, w in zip(got, want)]


def _exact_plain(ps, wsb, freqs, grad):
    """(E, d_ps, d_xi) of the plain chain on the card: the float32 product of
    ps ((B, C, N), or (C, V) shared) and ``quantile_coefficients``, summed,
    and autograd."""
    ps, xi = ps.detach().requires_grad_(), freqs.detach().requires_grad_()
    e = torch.sum((ps if ps.dim() == 3 else ps[None])
                  * quantile_coefficients(wsb, xi[None, :, None]), dim=-1)
    e.backward(grad)
    return e.detach(), ps.grad, xi.grad


def phase_exact_timings(dev) -> dict:
    """The exact forwards' coefficients at PHASE5_EXACT_ROWS (per genome:
    bound by bytes, ps and ws read once and ws once more for the tile sums
    forward, ws and ps read and d_ps written backward, 12 B a position
    each) and PHASE5_EXACT_SHARED (shared, bound by lane work: every item's
    coefficient of every slice and position); each kernel's E, d_ps and
    d_xi against float64 (relative norm errors: per genome under a tenth of
    the plain chain's, whose float32 scan runs over 646,000 weights; shared
    within the planes' tolerance, 1e-5 + 1e-7 C), its time beside its bound,
    the plain chain's (its product, row sum and autograd, float32 on the
    card) and the plain chain's own error."""
    out = {}
    b, c, n, real = PHASE5_EXACT_ROWS
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    w = torch.rand(b, n, generator=gen, device=dev)
    keys = torch.randn(b * c, n, generator=gen, device=dev)
    w[:, real:] = 0.0
    keys[:, real:] = keys[:, :1]  # the padding rows are one point: they sort together
    ps, ws, _ = sort_rows(keys, fsw_model._normalized(w))
    del keys, w
    freqs = torch.arange(FSW_OUT_DIM - c, FSW_OUT_DIM, dtype=torch.float32, device=dev)
    grad = torch.randn(b, c, generator=gen, device=dev)
    v3 = (b, c, n)
    rows_out = [*exact_coefficients(ps, ws, freqs)]
    rows_out[1:] = exact_coefficients_grad(ps, ws, freqs, rows_out[1], grad)
    want = (exact_coefficients_reference(ps.double().view(v3), ws.double().view(v3),
                                         freqs.double()),
            *exact_coefficients_grad_reference(ps.double().view(v3), ws.double().view(v3),
                                               freqs.double(), grad.double()))
    err = _exact_rel_errs((rows_out[0], rows_out[1].view(v3), rows_out[2]), want)
    plain_err = _exact_rel_errs(_exact_plain(ps.view(v3), ws.view(v3), freqs, grad), want)
    del want, rows_out
    check(all(a <= b / 10 for a, b in zip(err, plain_err)),
          f"exact_coefficients at {PHASE5_EXACT_ROWS}: relative errors {err} of E, d_ps and "
          f"d_xi against float64, not a tenth of the plain chain's {plain_err}")
    _, tile_sums = exact_coefficients(ps, ws, freqs)
    fwd_ms = cuda_ms(lambda: exact_coefficients(ps, ws, freqs), reps=10)
    bwd_ms = cuda_ms(lambda: exact_coefficients_grad(ps, ws, freqs, tile_sums, grad), reps=10)
    plain_ms = cuda_ms(lambda: _exact_plain(ps.view(v3), ws.view(v3), freqs, grad), reps=2,
                       warmup=1)
    bytes_ms = 1e3 * 12 * b * c * n / H100_BYTES_PER_S
    out["rows"] = {"shape": [b, c, n], "real_points": real, "forward_ms": fwd_ms,
                   "backward_ms": bwd_ms, "bound_ms": bytes_ms, "bound_by": "bytes",
                   "forward_operations_ms": 1e3 * b * c * real * EXACT_VALUE_INSTR_PER_COEFF
                   / H100_LANE_INSTR_PER_S,
                   "backward_operations_ms": 1e3 * b * c * real * REFRESH_INSTR_PER_COEFF
                   / H100_LANE_INSTR_PER_S,
                   "plain_forward_backward_ms": plain_ms, "rel_err_e_dps_dxi": err,
                   "plain_rel_err_e_dps_dxi": plain_err}
    del ps, ws, tile_sums
    b, c = PHASE5_EXACT_SHARED
    w = torch.rand(b, V_MAIN, generator=gen, device=dev)
    w[w < 0.2] = 0.0  # absent k-mers
    wn = fsw_model._normalized(w)
    ps, _, perm = sort_rows(torch.randn(c, V_MAIN, generator=gen, device=dev), wn[:1])
    freqs = torch.arange(c, dtype=torch.float32, device=dev)
    grad = torch.randn(b, c, generator=gen, device=dev)
    got = (exact_coefficients_shared(ps, perm, wn, freqs),
           *exact_coefficients_shared_grad(ps, perm, wn, freqs, grad))
    wsb = wn.double()[:, perm.long()]
    want = (exact_coefficients_reference(ps.double(), wsb, freqs.double()),
            *exact_coefficients_grad_reference(ps.double(), wsb, freqs.double(), grad.double()))
    del wsb
    err = _exact_rel_errs(got, want)
    plain_err = _exact_rel_errs(_exact_plain(ps, wn[:, perm.long()], freqs, grad), want)
    check(max(err) <= 1e-5 + 1e-7 * c, f"exact_coefficients_shared at {PHASE5_EXACT_SHARED}: "
          f"relative errors {err} of E, d_ps and d_xi against float64")
    fwd_ms = cuda_ms(lambda: exact_coefficients_shared(ps, perm, wn, freqs), reps=20)
    bwd_ms = cuda_ms(lambda: exact_coefficients_shared_grad(ps, perm, wn, freqs, grad), reps=20)
    plain_ms = cuda_ms(lambda: _exact_plain(ps, wn[:, perm.long()], freqs, grad), reps=5,
                       warmup=1)
    coeffs = b * c * V_MAIN
    out["shared"] = {"shape": [b, c, V_MAIN], "forward_ms": fwd_ms, "backward_ms": bwd_ms,
                     "forward_bound_ms": 1e3 * coeffs * EXACT_VALUE_INSTR_PER_COEFF
                     / H100_LANE_INSTR_PER_S,
                     "backward_bound_ms": 1e3 * coeffs * REFRESH_INSTR_PER_COEFF
                     / H100_LANE_INSTR_PER_S, "bound_by": "operations",
                     "plain_forward_backward_ms": plain_ms, "rel_err_e_dps_dxi": err,
                     "plain_rel_err_e_dps_dxi": plain_err}
    log(f"phase timings: exact_coefficients {json.dumps(out)}")
    return out


def phase_unsort_timings(dev) -> list[dict]:
    """The sort's backward at FSW training shapes: ``unsort`` (one library
    scatter_ by ``perm``) of a cotangent, bound by reading it and perm and
    writing the result once; checked to invert the sort."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    out = []
    for r, n in UNSORT_SHAPES:
        keys = torch.randn(r, n, generator=gen, device=dev)
        sk, _, perm = sort_rows(keys, torch.rand(1, n, generator=gen, device=dev))
        d = torch.randn(r, n, generator=gen, device=dev)
        ms = cuda_ms(lambda: unsort(d, perm), reps=20)
        check(torch.equal(unsort(sk, perm), keys), f"unsort at {(r, n)} does not invert the sort")
        n_bytes = 12 * r * n
        bound_ms = n_bytes / H100_BYTES_PER_S * 1e3
        out.append({"shape": f"R={r} x N={n}", "ms": ms, "bound_ms": bound_ms, "bound_by": "bytes",
                    "bytes": n_bytes})
    log(f"phase timings: unsort {json.dumps(out)}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    max_err = phase_kernel_vs_plain(dev)
    long_genome = phase_long_genome(dev)
    sort_err = phase_sort_vs_plain(dev)
    work = tempfile.mkdtemp(prefix="kf2vec_chip_smoke_")
    try:
        paths, q_dir, q_names = phase_main_paths(work, dev)
        serve = phase_serve(work, paths, q_dir, q_names)
        build, built = phase_build_library(work, q_dir, q_names)
        fsw = phase_train_fsw(work, built, q_dir, q_names)
        fsw_k8 = phase_fsw_k8(work, built, q_dir, q_names)
        fsw_k9 = phase_fsw_k9(work)
        fsw_k10 = phase_fsw_k10(work)
        zoo_out = phase_zoo(paths["dense"]["out_dir"])
        chunk = phase_train_chunks(work, built, q_dir, q_names)
        ranks, ranked = phase_ranks(work, built, q_dir)
        model_axis = phase_model_axis(work, ranked)
        phase_host_text(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    timing = phase_timings(dev)
    chunk_timing = phase_chunk_hist_timings(dev)
    sort_timing = phase_sort_timings(dev, PHASE5_SORT, reps=10)
    train_sort_timing = phase_sort_timings(dev, PHASE5_TRAIN_SORT, reps=50)
    axis_sort_timings = [phase_sort_timings(dev, shape, reps=50) for shape in MODEL_AXIS_SORTS]
    long_timings = [phase_sort_timings(dev, shape, reps=3 if shape[0] > FSW_OUT_DIM else 20)
                    for shape in PHASE5_SORT_LONG]
    radix_timings = [phase_sort_timings(dev, shape, reps=3 if shape[0] > FSW_OUT_DIM else 10)
                     for shape in PHASE5_SORT_RADIX]
    unsort_timing = phase_unsort_timings(dev)
    refresh_timing = phase_refresh_timings(dev)
    pergenome_timing = phase_pergenome_timings(dev)
    exact_timing = phase_exact_timings(dev)
    for tag, run in paths.items():
        log(f"phase timings: process_query_data {tag} stages (s) {json.dumps(run['stage_s'])}")
        res = serve[tag]
        log(f"phase timings: serve {tag}: ready {res['ready_s']} s, warm {res['warm']['wall_s']} s, "
            f"place {res['place']['wall_s']} s, place_features {res['place_features_1']['wall_s']} "
            f"and {res['place_features_2']['wall_s']} s; peak device memory {res['peak_mib']:.0f} MiB")
    log(f"phase timings: serve CLI to ready (-warm) {serve['cli']['ready_s']} s, place "
        f"{serve['cli']['place_s']} s")
    log(f"phase timings: build_library stages (s) {json.dumps(build['stage_s'])}; steps/s over "
        f"epochs 2-{BUILD_EPOCHS} {json.dumps(build['steps_per_s'])}; peak device memory "
        f"{build['peak_mib']:.0f} MiB; exports {json.dumps(build['exports'])}; host work in "
        f"the trainers (s) {json.dumps(build['host_s'])}")
    log(f"phase timings: train_fsw get_kmers {fsw['get_kmers_s']} s; per route (s, steps/s over "
        f"epochs 2-{FSW_EPOCHS} with and without refreshes, refresh s, peak MiB) " + json.dumps(
            {route: [run["seconds"], run["steps_per_s"], run["steps_per_s_without_refresh"],
                     run["refresh_s"], run["peak_mib"]] for route, run in fsw["routes"].items()})
        + f"; trained FSW library served in (s) {json.dumps(fsw['serve']['stage_s'])}")
    log(f"phase timings: train_chunks get_chunks {chunk['get_chunks_s']} s (counting "
        f"{chunk['get_chunks_count_s']} s, formatting {chunk['get_chunks_format_s']} s) over "
        f"{chunk['genomes']} genomes, {chunk['windows']} windows; classifier "
        f"{chunk['classifier_s']} s, distance {chunk['distance_s']} s; steps/s over epochs "
        f"2-{CHUNK_EPOCHS} {json.dumps(chunk['steps_per_s'])}; outside the epochs (s) "
        f"{json.dumps(chunk['outside_epochs_s'])}; peak device memory {chunk['peak_mib']:.0f} MiB; "
        f"sampler {chunk['sampler']['ms']} ms a batch; chunk library served in (s) "
        f"{json.dumps(chunk['serve']['stage_s'])}; the whole phase {chunk['phase_s']} s")
    log(f"phase timings: ranks on {smi}: steps/s over epoch 2 and bytes all-reduced per step, "
        "without a group / one-rank NCCL group / two ranks sharing the card over gloo (rank 0) "
        + json.dumps({name: [ranks["no_group"][name]["steps_per_s"],
                             ranks["world_size_1"][name]["steps_per_s"],
                             ranks["two_ranks_gloo"][name]["steps_per_s"],
                             ranks["world_size_1"][name]["all_reduce_bytes_per_step"],
                             ranks["two_ranks_gloo"][name]["all_reduce_bytes_per_step"]]
                      for name in ranks["no_group"]})
        + f"; count_canonical_sharded R = 2 {ranks['count_sharded']['seconds']:.3f} s; two-rank "
        f"launch {ranks['two_ranks_wall_s']:.1f} s; the whole phase {ranks['phase_s']:.1f} s")
    log(f"phase timings: model_axis on {smi}: grid {MODEL_AXIS_GRID[0]} x {MODEL_AXIS_GRID[1]}, "
        "rank 0's steps/s over epoch 2 and bytes all-reduced per step by group " + json.dumps(
            {name: [run["steps_per_s"], run["all_reduce_bytes_per_step"]]
             for name, run in model_axis["trainers"].items()})
        + f"; the whole phase {model_axis['phase_s']:.1f} s")
    log(f"phase timings: fsw_k8 {fsw_k8['seconds']:.1f} s; the k=8 query's stages (s) "
        f"{json.dumps(fsw_k8['query']['stage_s'])}")
    log(f"phase timings: fsw_k9 {fsw_k9['seconds']:.1f} s; the refresh at {K9_REFRESH_ITEMS} "
        f"items {fsw_k9['timings']['refresh']['ms']:.3f} ms, the training chunk's sort "
        f"{fsw_k9['timings']['train_sort']['ms']:.3f} ms, its coefficients forward "
        f"{fsw_k9['timings']['exact_shared']['forward_ms']:.3f} and backward "
        f"{fsw_k9['timings']['exact_shared']['backward_ms']:.3f} ms")
    log(f"phase timings: fsw_k10 {fsw_k10['seconds']:.1f} s (lazy training "
        f"{fsw_k10['lazy']['seconds']:.1f} s, its refreshes {json.dumps(fsw_k10['lazy']['refresh_s'])}, "
        f"exact {fsw_k10['exact']['seconds']:.1f} s, query on the card "
        f"{fsw_k10['query']['cuda_s']:.2f} s and of 2 on the CPU {fsw_k10['query']['cpu_s']:.2f} s); "
        f"zoo {zoo_out['seconds']:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    by_path = {name: {tag: run["launches"][name] for tag, run in paths.items()}
               for name in ("kmer_hist", "sort_rows")}
    for name in by_path:
        by_path[name]["build_library"] = build["launches"][name]
    by_path["kmer_hist"]["train_fsw"] = fsw["kmer_hist_launches"] + sum(
        run["launches"]["kmer_hist"] for run in fsw["routes"].values())
    by_path["sort_rows"]["train_fsw"] = sum(
        run["launches"]["sort_rows"] for run in fsw["routes"].values())
    for name in by_path:
        by_path[name]["serve"] = serve["dense"]["launches"][name] + serve["fsw"]["launches"][name]
    by_path["kmer_hist"]["get_chunks"] = chunk["get_chunks_launches"]
    by_path["kmer_hist"]["train_chunks"] = chunk["launches"]["kmer_hist"]
    by_path["sort_rows"]["train_chunks"] = chunk["launches"]["sort_rows"]
    for name in by_path:  # the ranked paths: the one-rank group in this process
        by_path[name]["train_ddp"] = sum(run["launches"][name]
                                         for run in ranks["world_size_1"].values())
        by_path[name]["train_ddp_two_ranks_rank0"] = sum(
            run["launches"][name] for run in ranks["two_ranks_gloo"].values())
    by_path["kmer_hist"]["count_sharded"] = ranks["count_sharded"]["launches"]
    for name in by_path:  # both ranks, rank 0's exports included
        by_path[name]["train_model_axis"] = sum(sum(run[f"{name}_launches"])
                                                for run in model_axis["trainers"].values())
    by_path["kmer_hist"]["fsw_k8"] = sum(run["kmer_hist"] for run in fsw_k8["launches"].values())
    for path in ("lazy_shared", "exact_shared", "query"):
        by_path["sort_rows"][f"fsw_k8_{path}"] = fsw_k8["launches"][path]["sort_rows"]
    for path in ("lazy_shared", "exact_shared"):
        by_path["sort_rows"][f"fsw_k9_{path}"] = (
            fsw_k9["routes"][f"{path}_cuda"]["launches"]["sort_rows"])
    by_path["sort_rows"]["fsw_k9_query"] = fsw_k9["query"]["cuda"]["sort_rows"]
    by_path["kmer_hist"]["fsw_k10"] = fsw_k10["get_kmers_launches"]
    radix_launches = {"fsw_k10_lazy": fsw_k10["lazy"]["launches"]["sort_rows"],
                      "fsw_k10_exact": fsw_k10["exact"]["launches"]["sort_rows"],
                      "fsw_k10_query": fsw_k10["query"]["cuda"]["sort_rows"]}
    by_path["sort_rows"].update(radix_launches)
    refresh_by_path = {
        "train_fsw": sum(run["launches"]["refresh_planes"] for run in fsw["routes"].values()),
        "fsw_k8_lazy_shared": fsw_k8["launches"]["lazy_shared"]["refresh_planes"],
        "train_ddp": sum(run["launches"]["refresh_planes"]
                         for run in ranks["world_size_1"].values()),
        "train_ddp_two_ranks_rank0": sum(run["launches"]["refresh_planes"]
                                         for run in ranks["two_ranks_gloo"].values()),
        "train_model_axis": sum(sum(run["refresh_planes_launches"])
                                for run in model_axis["trainers"].values()),
        "fsw_k10_c6": fsw_k10["memory"]["shared_refresh_k9"]["launches"]}
    goal = long_timings[0]
    report = {"kernels": [{
        "name": "kmer_hist", "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
        "tpu_kernels": ["B1", "B2"], "launches": by_path["kmer_hist"]["dense"],
        "launches_by_path": by_path["kmer_hist"], "matches_plain": max_err == 0.0,
        "max_abs_err": max_err, "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "repeats_ms": {name: timing[f"ms_{name}"] for name in ("homopolymer", "dinucleotide")},
        "get_chunks_shape": {key: chunk_timing[key] for key in
                             ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "long_genome": long_genome,
    }, {
        "name": "sort_rows", "route": "cuda", "source": SORT_SOURCE, "replaces": SORT_REPLACES,
        "tpu_kernels": ["B3"], "launches": by_path["sort_rows"]["fsw"],
        "launches_by_path": by_path["sort_rows"], "matches_plain": sort_err == 0.0,
        "max_abs_err": sort_err, "ms": sort_timing["ms"], "plain_ms": sort_timing["plain_ms"],
        "bound_ms": sort_timing["bound_ms"], "bound_by": sort_timing["bound_by"],
        "library_ms": sort_timing["library_ms"],
        "long_rows": [{key: timing[key] for key in (
            "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "cluster")}
            for timing in long_timings],
        "long_rows_goal": {"shape": goal["shape"], "ms": goal["ms"], "goal_ms": LONG_SORT_GOAL_MS,
                           "goal_met": goal["ms"] <= LONG_SORT_GOAL_MS,
                           "torch_sort_ms": goal["library_ms"],
                           "faster_than_torch_sort": goal["ms"] < goal["library_ms"]},
        "long_launches_by_path": {path: fsw_k8["launches"][path]["sort_rows_long"]
                                  for path in ("lazy_shared", "exact_shared", "query")},
        "radix_rows": [{key: timing[key] for key in (
            "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "faster_than_torch_sort")} for timing in radix_timings],
        "radix_launches_by_path": radix_launches,
        "train_shape": {key: train_sort_timing[key] for key in
                        ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "model_axis_shapes": [{key: timing[key] for key in
                               ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
                              for timing in axis_sort_timings],
        "model_axis_rows_per_call": {name: run["sort_rows_rows"] for name, run in
                                     model_axis["trainers"].items() if name.startswith("fsw")},
        "train_fsw_routes": {route: {key: run[key] for key in (
            "launches_outside_exports", "export_launches", "refreshes")}
            for route, run in fsw["routes"].items()},
        "unsort": unsort_timing,
    }, {
        "name": "lazy_refresh", "route": "cuda", "source": REFRESH_SOURCE,
        "replaces": REFRESH_REPLACES, "tpu_kernels": [],
        "launches": refresh_by_path["train_fsw"], "launches_by_path": refresh_by_path,
        **refresh_timing,
    }, {
        "name": "lazy_refresh_pergenome", "route": "cuda", "source": REFRESH_SOURCE,
        "replaces": PERGENOME_REPLACES, "tpu_kernels": [],
        "launches": fsw["routes"]["lazy_pergenome"]["launches"]["pergenome_planes"],
        "launches_by_path": {
            "train_fsw": sum(run["launches"]["pergenome_planes"] for run in fsw["routes"].values()),
            "fsw_k10_lazy": fsw_k10["lazy"]["launches"]["pergenome_planes"]},
        **pergenome_timing,
    }, {
        "name": "exact_coefficients", "route": "cuda", "source": REFRESH_SOURCE,
        "replaces": EXACT_REPLACES, "tpu_kernels": [],
        "launches": fsw["routes"]["exact_pergenome"]["launches"]["exact_coefficients"],
        "launches_by_path": {
            "train_fsw": {route: run["launches"]["exact_coefficients"]
                          for route, run in fsw["routes"].items()},
            "fsw_k10_exact": fsw_k10["exact"]["launches"]["exact_coefficients"],
            "fsw_k10_query": fsw_k10["query"]["cuda"]["exact_coefficients"]},
        **exact_timing,
    }]}
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[2:]) if sys.argv[1:2] == [RANK_FLAG] else main())
