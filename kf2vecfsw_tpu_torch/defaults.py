"""CLI defaults, kept identical to the reference (main.py:80-101)."""

DEFAULT_K_LEN = 7
MIN_K_LEN = 2
MAX_K_LEN = 31
DEFAULT_SUBTREE_SZ = 850
DEFAULT_MULTIPLIER = 100

HIDDEN_SIZE_FC1 = 2048
EMBEDDING_SIZE = 1024
BATCH_SIZE = 16

DEFAULT_CL_EPOCHS = 2000
DEFAULT_DI_EPOCHS = 8000

LEARNING_RATE = 1e-5
LEARNING_RATE_MIN = 3e-6
LEARNING_RATE_DECAY = 2000

# Step-LR schedule constants (train_model_set.py:63-64)
LEARNING_RATE_BASE = 0.1
LEARNING_RATE_UPDATE_FREQ = 100

SEED = 28
DEFAULT_BLOCK_SZ = 4000

CHUNK_SZ = 10000      # minimum chunk size (main.py:100)
CHUNK_CNT_THR = 5     # minimum chunks to keep a genome (main.py:101)

FEATURES_SCALER = 1e4  # train_*_model*.py `features_scaler`

# FSW model defaults (main.py:1208-1210)
FSW_OUT_DIM = 512
FSW_BASE_DIM = 4

# auto-engaged lazy sort-refresh cadence of the FSW trainer (the JAX
# package's). -fsw_lazy_refresh 0 forces the exact per-step sort.
FSW_LAZY_AUTO_REFRESH = 128
