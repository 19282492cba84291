"""Operations and bytes the inputs need, counted from shapes, and the peaks
of the card they are held against.

A product of (m, n) by (n, p) is 2 m n p operations; a sum of products over
n terms 2 n; sorts, gathers and elementwise work count 0. A kernel's bytes
count each input byte read once and each output byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores (the port keeps TF32 off)
H100_BYTES_PER_S = 3.35e12  # HBM3


def mlp_flops(rows: int, widths: list[int]) -> int:
    """Linear layers of ``widths`` = [in, hidden, ..., out] on ``rows`` rows."""
    return sum(2 * rows * a * b for a, b in zip(widths, widths[1:]))


def pairwise_flops(rows: int, e: int) -> int:
    """The squared distances of all pairs of ``rows`` embeddings."""
    return 2 * rows * rows * e


def dense_forward_flops(cfg: dict, vocab: int, rows: int) -> int:
    return mlp_flops(rows, [vocab, cfg["hidden_size"], cfg["embedding_size"]])


def fsw_point_set_flops(cfg: dict, n_points: int) -> int:
    """The FSW layer's products on one point set of ``n_points`` k-mers: the
    points from the lookup (a one-hot product), the slice projections and
    E's sums."""
    k, bd, c = cfg["k"], cfg["base_dim"], cfg["fsw_out_dim"]
    return 2 * n_points * k * 4 * bd + 2 * c * k * bd * n_points + 2 * c * n_points


def fsw_head_flops(cfg: dict, rows: int) -> int:
    return mlp_flops(rows, [cfg["fsw_out_dim"], cfg["hidden_size"], cfg["embedding_size"]])


def lazy_step_forward_flops(cfg: dict, rows: int) -> int:
    """A lazy FSW step's forward: the (C, k, 4) projections of the slice
    blocks on the lookup, E from the batch's planes, the MLP."""
    k, bd, c = cfg["k"], cfg["base_dim"], cfg["fsw_out_dim"]
    return 2 * c * k * bd * 4 + 2 * rows * c * k * 4 + fsw_head_flops(cfg, rows)


def train_step_flops(cfg: dict, vocab: int, rows: int) -> int:
    """One training step on ``rows`` items: forward, and a backward of twice
    its products."""
    if cfg["model"] == "fsw":
        fwd = lazy_step_forward_flops(cfg, rows)
    else:
        fwd = dense_forward_flops(cfg, vocab, rows)
    return 3 * (fwd + pairwise_flops(rows, cfg["embedding_size"]))


def shared_refresh_flops(cfg: dict, vocab: int, items: int) -> int:
    """A refresh of the shared-vocab lazy route over ``items`` items: the
    vocab's points and projections once, then per item d E / d xi's sums
    and the segment sums of the unsorted coefficients (a product with the
    (V, 4k) one-hot digits)."""
    k, c = cfg["k"], cfg["fsw_out_dim"]
    return fsw_point_set_flops(cfg, vocab) - 2 * c * vocab + items * (2 * c * vocab * (4 * k + 1))


def sort_rows_bound_s(rows: int, n: int, payload_rows: int) -> float:
    """The least time of one ``sort_rows`` launch: the f32 keys and payload
    rows read, the sorted keys, gathered payload and int32 permutation
    written, at H100_BYTES_PER_S."""
    return (4 * rows * n + 4 * payload_rows * n + 12 * rows * n) / H100_BYTES_PER_S
