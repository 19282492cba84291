"""kf2vecfsw-tpu on PyTorch and CUDA: the port of the JAX package to Hopper.

The serving path of kf2vec (``process_query_data``: genome -> `.kf` ->
subtree class -> `.kf` or FSW `.npy` point set -> APPLES distance matrix)
runs here on an NVIDIA card:

- canonical k-mer counting through one hand-written CUDA kernel
  (``kernels/csrc/kmer_hist.cu``), built with ``nvcc`` on first use,
- the row sort of the FSW embedding through another
  (``kernels/csrc/sort_rows.cu``),
- the classifier, dense and FSW distance models as ``nn.Module``s,
- the exact blocked cdist as plain tensor code.

Libraries of dense models are built here too (``build_library``:
``get_frequencies`` -> ``divide_tree`` -> ``get_distances`` ->
``train_classifier`` -> ``train_model_set -no_fsw``), with the trainers as
plain PyTorch on cuBLAS and ``torch.optim.Adam``; ``train_model_set``
trains FSW models by default, through the row sort under autograd. The
trainers also run data-parallel over ``torch.distributed`` ranks, one
process per card (``parallel/``).

Every entry point runs on ``device="cuda"`` unless the caller asks for the
CPU; the JAX package ``kf2vecfsw_tpu`` is the reference it is tested
against, and nothing here imports it. File formats (`.kf`, `.npy`,
`.ckpt`, ``classes.out``, APPLES matrices, `.emb`) are the JAX package's.
"""

__version__ = "0.1.0"
