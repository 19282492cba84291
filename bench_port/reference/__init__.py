"""The plain reference: straightforward NumPy and PyTorch versions of what
the cells run, written from the published description of kf2vec and its FSW
fork. It imports nothing of the program under test (``kf2vecfsw_tpu_torch``)
and nothing of the JAX package, and takes no weights or tables that the
program made: the benchmark hands it the inputs it made itself."""
