"""The window's share of the card's float32 peak: the operations of the
work the window completed, counted from shapes (``counts``), over the
traced window's seconds at ``counts.H100_FP32_FLOPS``."""

from bench_port import counts


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * r.run.flops() / (r.trace.window_s * counts.H100_FP32_FLOPS)
